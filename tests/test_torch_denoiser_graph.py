"""The denoiser call's CUDA graph (``models.denoiser_graph``) on the CPU:
which calls run eagerly (a CPU tensor, autograd on, the tiled and turbo
model functions, a model split across processes), the ``model.call``
span's ``graph`` attribute, the launch counts of a capture and its
replays, and the static inputs (a request's k/v moved in, smaller
signatures as views, growth, a step's timestep rows). The graphs
themselves need a card: ``tests/test_torch_gpu_denoiser_graph.py``."""

from types import SimpleNamespace

import pytest
import torch

from diffbir_tpu_torch.models import denoiser_graph as dg
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.ops import _cuda
from diffbir_tpu_torch.sampler.base import GuidedModel, timestep_vector
from diffbir_tpu_torch.utils import spans

GRID = (999.0, 500.0, 1.0)


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return ControlLDM.tiny().eval()


def _request(cldm, rows, hw=8, grid=GRID):
    gen = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, hw, hw, 4, generator=gen)
    cond = {"c_txt": torch.randn(rows, 77, 64, generator=gen),
            "c_img": torch.randn(rows, hw, hw, 4, generator=gen)}
    with torch.no_grad():
        tables = cldm.make_hoist_tables(cond["c_txt"], grid)
    return x, cond, tables


def test_a_cpu_call_runs_eagerly(tiny):
    from diffbir_tpu_torch.pipeline import model_function

    x, cond, tables = _request(tiny, 2)
    fn = model_function(tiny, 0.7, tables)
    with torch.no_grad():
        out = fn(x, 500.0, cond)
        ref = tiny(x, timestep_vector(500.0, x), cond, control_scales=0.7,
                   hoisted=tables.lookup(500.0))
    assert isinstance(fn, dg.DenoiserCall) and fn.graph == dg.EAGER
    assert torch.equal(out, ref)
    assert tiny not in dg._models


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("grad", [True, False])
def test_only_a_card_tensor_without_autograd_is_graph_safe(grad, on_card):
    x = SimpleNamespace(is_cuda=on_card)
    with torch.set_grad_enabled(grad):
        assert dg.graph_safe(x) is (on_card and not grad)


def test_tiled_and_turbo_model_functions_run_eagerly(tiny, monkeypatch):
    """They are other callables than the graphed one, and their
    ``model.call`` spans read ``graph`` 0; a graphed function's read its
    ``graph``."""
    from diffbir_tpu_torch.pipeline import tiled_model_function

    monkeypatch.setattr(spans, "_enabled", True)
    x, cond, tables = _request(tiny, 1)
    fns = {"tiled": tiled_model_function(tiny, 1.0, 64, 32),
           "turbo": tiny.make_cached_control_model(1.0, 2, False, tables),
           "replayed": _Stub(dg.REPLAY)}
    read = {}
    for name, fn in fns.items():
        assert not isinstance(fn, dg.DenoiserCall)
        model = GuidedModel(fn, cond, None)
        with torch.no_grad():
            model.raw(x, 500.0)
        read[name] = spans.snapshot()[-1].attrs["graph"]
    assert read == {"tiled": 0, "turbo": 0, "replayed": 2}


class _Stub:
    def __init__(self, graph):
        self.graph = graph

    def __call__(self, x, t, c):
        return x


def test_a_model_split_across_processes_runs_eagerly(tiny, monkeypatch):
    """Spatial parallelism wraps the model, tensor parallelism marks its
    column layers with their group: neither is graphed."""
    from diffbir_tpu_torch.parallel.inference import SpatialParallel

    assert dg.DenoiserCall(tiny).whole
    assert not dg.DenoiserCall(SpatialParallel(tiny, None)).whole
    monkeypatch.setattr(dg.dist, "is_initialized", lambda: True)
    assert dg.DenoiserCall(tiny).whole
    layer = next(m for m in tiny._denoisers() if isinstance(m, torch.nn.Linear))
    monkeypatch.setattr(layer, "tp_group", None, raising=False)
    assert not dg.DenoiserCall(tiny).whole


def test_a_capture_counts_no_launch_and_a_replay_its_recorded_ones(monkeypatch):
    """A launch recorded into a graph goes to this thread's capture tally,
    not to ``launches``; another thread's launch meanwhile counts; each
    replay adds the tally."""
    import threading

    kernel = _cuda.CudaKernel("flash_attention_fwd.cu", "stand_in", [])
    monkeypatch.setattr(kernel, "load", lambda: lambda *args: 0)
    capturing = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(capturing, "on", False))
    kernel.launch()
    with _cuda.capture_tally() as made:
        capturing.on = True
        for _ in range(23):
            kernel.launch()
        other = threading.Thread(target=kernel.launch)
        other.start()
        other.join()
        capturing.on = False
    assert made == {kernel: 23} and kernel.launches == 2
    kernel.launch()   # after the block: counted
    for _ in range(3):
        _cuda.count(made)
    assert kernel.launches == 3 + 3 * 23


def _graphs_for(dc):
    g = dg.DenoiserGraphs()
    g.kv_widths, g.emb_widths = dc.kv_widths, dc.emb_widths
    return g


def test_a_request_moves_its_kv_tables_into_the_static_inputs(tiny):
    x, cond, tables = _request(tiny, 4)
    kept = {m: v.clone() for m, v in tables.kv.items()}
    dc = dg.DenoiserCall(tiny, 1.0, tables)
    g = _graphs_for(dc)
    sig = dc.signature(x, cond)
    assert g._fit(sig, x.device) == {"x", "t", "c_img", "c_txt", "kv", "emb"}
    g._bind(dc, sig)
    base = g.buffers["kv"].untyped_storage().data_ptr()
    assert g.owner() is dc
    for m, v in tables.kv.items():
        assert v.untyped_storage().data_ptr() == base and torch.equal(v, kept[m])
        assert tables.lookup(500.0)[m] is v


def test_smaller_signatures_are_views_of_the_buffers_and_larger_ones_grow_them(tiny):
    x, cond, tables = _request(tiny, 4)
    dc = dg.DenoiserCall(tiny, 1.0, tables)
    g = _graphs_for(dc)
    big = dc.signature(x, cond)
    g._fit(big, x.device)
    small_x, small_cond, _ = _request(tiny, 2)
    small = dc.signature(small_x, small_cond)
    assert g._fit(small, x.device) == set()
    views = g._inputs(small)
    assert views[0].shape == (2, 8, 8, 4) and views[0].data_ptr() == g.buffers["x"].data_ptr()
    assert all(v.shape[0] == 2 for v in views[3].values())
    larger_x, larger_cond, _ = _request(tiny, 6)
    assert g._fit(dc.signature(larger_x, larger_cond), x.device) == {
        "x", "t", "c_img", "c_txt", "kv", "emb"}
    assert g.buffers["x"].numel() == larger_x.numel()


def test_a_steps_rows_from_the_packed_tables_are_its_lookup(tiny):
    x, cond, tables = _request(tiny, 2)
    dc = dg.DenoiserCall(tiny, 1.0, tables)
    g = _graphs_for(dc)
    sig = dc.signature(x, cond)
    g._fit(sig, x.device)
    g._bind(dc, sig)
    hoisted = g._inputs(sig)[3]
    for t in GRID:
        g.buffers["emb"][:tables.packed.shape[1]].copy_(tables.packed[tables.row(t)])
        rows = tables.lookup(t)
        assert set(rows) == set(hoisted)
        for m, v in rows.items():
            assert torch.equal(hoisted[m], v)
