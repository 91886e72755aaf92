"""The denoiser call replayed as a CUDA graph (``models.denoiser_graph``) on
the card, on the full-width SD2.1 ControlLDM (random bf16 weights): a
replay gives the eager call's answer at 2 and 8 rows, hoisted and not, in
the default, fused and int8 modes; requests in turn (other prompts,
conditions, seeds and batches) each get their own eager answer; a request
that finds the static inputs held by another live one runs eagerly, and
requests from four threads at once get their own answers; a
``set_mode`` or a quantisation after a capture makes a new graph;
``CudaKernel.launches`` after N replays is N times the captured count, as
the profiler counts K1; a model keeps the graphs of its last used
signatures, and one memory pool through growth and a mode change.

These tests need a card: they skip without one. Run them there without the
conftest (it imports JAX). Where both run in one process, this file runs after
``tests/test_torch_gpu.py`` (its name sorts after it): that file's test of the
spans' clock against the profiler can find kernel records missing once
full-width eager calls have run in the process:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_denoiser_graph.py -q
"""

import numpy as np
import pytest
import torch

from diffbir_tpu_torch.models import denoiser_graph as dg
from diffbir_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

LATENT = 64
GRID = (999.0, 666.0, 333.0, 1.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(cuda, mode="default", seed=0):
    from diffbir_tpu_torch.models.cldm import ControlLDM
    from diffbir_tpu_torch.models.layers import random_init_

    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device=cuda)
    with torch.no_grad():
        random_init_(cldm, torch.Generator(device=cuda).manual_seed(seed))
    return cldm.eval().set_mode(mode)


@pytest.fixture(scope="module")
def models(cuda):
    made = {}

    def get(mode):
        if mode not in made:
            made[mode] = _model(cuda, mode)
        return made[mode]

    return get


def _inputs(cuda, rows, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(rows, LATENT, LATENT, 4, generator=gen, device=cuda)
    cond = {"c_txt": torch.randn(rows, 77, 1024, generator=gen, device=cuda).bfloat16(),
            "c_img": torch.randn(rows, LATENT, LATENT, 4, generator=gen,
                                 device=cuda).bfloat16()}
    return x, cond


def _eager(cldm, x, t, cond, tables, strength=1.0):
    from diffbir_tpu_torch.sampler.base import timestep_vector

    with torch.no_grad():
        return cldm(x, timestep_vector(t, x), cond, control_scales=strength,
                    hoisted=None if tables is None else tables.lookup(t)).clone()


@pytest.mark.parametrize("hoist", [True, False])
@pytest.mark.parametrize("rows", [2, 8])
@pytest.mark.parametrize("mode", ["default", "fused", "int8"])
def test_a_replay_is_the_eager_call(models, cuda, mode, rows, hoist):
    """Capture at one step, replays at others with new x: each equals the
    eager call on the same inputs bit for bit."""
    cldm = models(mode)
    x, cond = _inputs(cuda, rows, seed=rows)
    tables = None
    if hoist:
        with torch.no_grad():
            tables = cldm.make_hoist_tables(cond["c_txt"], GRID)
    refs = [_eager(cldm, x * (i + 1), t, cond, tables, 0.8) for i, t in enumerate(GRID)]
    fn = dg.DenoiserCall(cldm, 0.8, tables)
    seen = []
    with torch.no_grad():
        for i, t in enumerate(GRID):
            out = fn(x * (i + 1), t, cond)
            seen.append(fn.graph)
            assert torch.equal(out, refs[i]), (mode, rows, hoist, t)
    assert seen[0] in (dg.CAPTURE, dg.REPLAY) and seen[1:] == [dg.REPLAY] * 3
    assert bool(torch.isfinite(refs[0]).all())


def test_requests_in_turn_get_their_own_eager_answers(cuda, monkeypatch):
    """Three requests through the pipeline (other prompts, condition images,
    seeds and batches; then the first again): each equals its eager answer,
    and their denoiser calls were replays but for the first call of each
    new signature."""
    from diffbir_tpu_torch.pipeline import IdentityCleanerPipeline
    from diffbir_tpu_torch.profile_step import stand_in_tokenizer
    from diffbir_tpu_torch.schedule import Schedule
    from diffbir_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "_enabled", True)
    cldm = _model(cuda, seed=1)
    pipe = IdentityCleanerPipeline(cldm, Schedule.v21(), cuda, min_cond_size=512,
                                   tokenizer=stand_in_tokenizer())
    rng = np.random.default_rng(3)
    requests = [(rng.integers(0, 256, (1, 128, 128, 3), dtype=np.uint8), "a red house", 11),
                (rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8), "two cats", 12)]
    requests.append(requests[0])
    kw = dict(steps=4, cfg_scale=4.0, sampler_type="edm_dpm++_3m_sde")
    graphed, modes = [], []
    for lq, prompt, seed in requests:
        spans.drain()
        graphed.append(pipe.run(lq, pos_prompt=prompt, seed=seed, **kw))
        modes.append([s.attrs["graph"] for s in spans.drain() if s.name == "model.call"])
    assert modes == [[dg.CAPTURE] + [dg.REPLAY] * 3] * 2 + [[dg.REPLAY] * 4]
    monkeypatch.setattr(dg, "graph_safe", lambda x: False)
    for (lq, prompt, seed), out in zip(requests, graphed):
        assert np.array_equal(out, pipe.run(lq, pos_prompt=prompt, seed=seed, **kw))
    assert not np.array_equal(graphed[0], graphed[1][:1])


def test_a_second_live_request_runs_eagerly(cuda):
    """The static inputs hold one request's k/v: while that request's call
    object lives, another request's calls run eagerly (and right)."""
    cldm = _model(cuda, seed=2)
    x, cond = _inputs(cuda, 2, seed=5)
    with torch.no_grad():
        first = dg.DenoiserCall(cldm, 1.0, cldm.make_hoist_tables(cond["c_txt"], GRID))
        second = dg.DenoiserCall(cldm, 1.0, cldm.make_hoist_tables(cond["c_txt"] * 2, GRID))
        first(x, GRID[0], cond)
        ref = _eager(cldm, x, GRID[1], cond, second.tables)
        assert torch.equal(second(x, GRID[1], cond), ref) and second.graph == dg.EAGER
        del first
        assert torch.equal(second(x, GRID[1], cond), ref) and second.graph == dg.REPLAY


def test_requests_from_threads_get_their_own_answers(cuda):
    """Four requests at once from four threads (2, 2, 4 and 8 rows; the
    interpreter switching threads every 10 us): the storage goes to one
    request at a time, grows under the others, and every call's answer is
    its eager one."""
    import sys
    import threading

    cldm = _model(cuda, seed=5)
    work = []
    with torch.no_grad():
        for i, rows in enumerate((2, 2, 4, 8)):
            x, cond = _inputs(cuda, rows, seed=20 + i)
            tables = cldm.make_hoist_tables(cond["c_txt"], GRID)
            refs = [_eager(cldm, x * (k + 1), t, cond, tables) for k, t in enumerate(GRID)]
            work.append((x, cond, tables, refs))
    torch.cuda.synchronize()
    got, errors = [None] * len(work), []

    def request(i):
        x, cond, tables, refs = work[i]
        try:
            with torch.no_grad():
                fn = dg.DenoiserCall(cldm, 1.0, tables)
                got[i] = [(fn(x * (k + 1), t, cond), fn.graph) for k, t in enumerate(GRID)]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=request, args=(i,)) for i in range(len(work))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    torch.cuda.synchronize()
    for (_, _, _, refs), outs in zip(work, got):
        for ref, (out, _) in zip(refs, outs):
            assert torch.equal(out, ref)
    assert any(g != dg.EAGER for outs in got for _, g in outs)


def test_a_mode_change_or_a_quantisation_makes_a_new_graph(cuda):
    from diffbir_tpu_torch.models.cldm import quantize_dense_params

    cldm = _model(cuda, seed=3)
    x, cond = _inputs(cuda, 2, seed=6)
    graphs = dg.graphs_of(cldm)
    fn = dg.DenoiserCall(cldm, 1.0, None)
    steps = []
    with torch.no_grad():
        for change in (None, lambda: cldm.set_mode("fused"),
                       lambda: quantize_dense_params(cldm)):
            if change is not None:
                change()
            ref = _eager(cldm, x, 500.0, cond, None)
            for _ in range(2):
                assert torch.equal(fn(x, 500.0, cond), ref)
                steps.append(fn.graph)
            assert len(graphs.graphs) == 1
    assert steps == [dg.CAPTURE, dg.REPLAY] * 3


def test_replays_count_their_recorded_launches(cuda):
    """K1's counter after N replays moves by N times the launches of one
    eager call, which is what the profiler sees."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cldm = _model(cuda, seed=4)
    x, cond = _inputs(cuda, 8, seed=7)
    with torch.no_grad():
        tables = cldm.make_hoist_tables(cond["c_txt"], GRID)
        before = fa.KERNEL_TC.launches
        _eager(cldm, x, GRID[0], cond, tables)
        per_call = fa.KERNEL_TC.launches - before
        fn = dg.DenoiserCall(cldm, 1.0, tables)
        fn(x, GRID[0], cond)   # the capture: its warm-up call runs
        assert fn.graph == dg.CAPTURE
        assert fa.KERNEL_TC.launches - before == 2 * per_call
        torch.cuda.synchronize()
        n, before = 3, fa.KERNEL_TC.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for t in GRID[1:]:
                fn(x, t, cond)
            torch.cuda.synchronize()
    seen = sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "flash_fwd_tc_kernel" in e.name)
    assert per_call > 0
    assert fa.KERNEL_TC.launches - before == n * per_call == seen


def test_a_model_keeps_the_graphs_of_its_last_used_signatures(cuda, monkeypatch):
    """With room for two graphs, a third signature drops the least recently
    used one, whose next call is captured again; every answer is the eager
    one."""
    monkeypatch.setattr(dg, "MAX_GRAPHS", 2)
    cldm = _model(cuda, seed=6)
    x, cond = _inputs(cuda, 2, seed=8)
    graphs = dg.graphs_of(cldm)
    seen = []
    with torch.no_grad():
        for strength in (0.5, 0.7, 0.5, 0.9, 0.7, 0.5):
            fn = dg.DenoiserCall(cldm, strength, None)
            assert torch.equal(fn(x, 500.0, cond), _eager(cldm, x, 500.0, cond, None, strength))
            seen.append(fn.graph)
            assert len(graphs.graphs) <= 2
    assert seen == [dg.CAPTURE, dg.CAPTURE, dg.REPLAY, dg.CAPTURE, dg.CAPTURE, dg.CAPTURE]
    assert [s.strength for s in graphs.graphs] == [0.7, 0.5]


def test_growth_and_a_mode_change_keep_the_one_pool(cuda):
    """Captures on grown buffers and after a ``set_mode`` go into the pool
    of the model's first capture (no pool is made anew), and answer as the
    eager call."""
    cldm = _model(cuda, seed=7)
    graphs = dg.graphs_of(cldm)
    pools = []
    with torch.no_grad():
        for rows, mode in ((2, None), (4, None), (4, "fused")):
            if mode is not None:
                cldm.set_mode(mode)
            x, cond = _inputs(cuda, rows, seed=30 + rows)
            fn = dg.DenoiserCall(cldm, 1.0, None)
            assert torch.equal(fn(x, 500.0, cond), _eager(cldm, x, 500.0, cond, None))
            assert fn.graph == dg.CAPTURE
            pools.append(graphs.pool)
    assert pools[0] is not None and pools == [pools[0]] * 3
