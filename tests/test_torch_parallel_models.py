"""Spatial parallelism of the VAE and the cleaners, and tensor-parallel
SwinIR (``parallel/inference.py``, ``parallel/tp.py``,
``parallel/collectives.py``) on two CPU processes over gloo, against the
JAX package's functions.

One spawn of two processes (``tests/test_torch_parallel.py``'s ``spawn``,
under its timeout, through the DIFFBIR_* launch contract) computes every
case; the JAX references are jitted once for the module, on the conftest's
8 virtual devices: each model's single-device output and
``jax_inference.spatial_parallel(fn, mesh)``'s on a 2-device mesh. The
weights are JAX trees (``tests.test_torch_models.fill_params``) loaded
through ``flax_to_state_dict``:

- the tiny VAE (``ControlLDM.tiny``'s: three ``Downsample``s, so every
  band starts on an even row at every level) banded: ``encode_moments``
  on a 64x48 image, ``decode`` of an 8x6 latent, and the decode's gradient
  with respect to z against ``jax.grad`` (guidance differentiates through
  it);
- a tiny SwinIR (window 8, 6 heads) banded at 256x128 (bands of two window
  rows) and at 128x192 (one window row a band: its shift must stay), then
  tensor-parallel (3 heads a process) at 256x128; a tiny SCUNet at
  128x96 and BSRNet (x4) on a 16x12 LQ, banded;
- ``tp_dim`` against JAX's ``tp_spec`` on SwinIR's and SCUNet's trees at
  2 and 4 processes, and ``tp_plan``'s SwinIR units;
- the routing of the VAE's d = 512 attention on a band (``kv_gathered``):
  the whole image's token count decides, as in one process;
- three planted faults: a non-cyclic shift (zeros for the wrapped rows),
  every band masked as the last, the VAE ``Downsample``'s halo row taken
  from above; each must fail the limit;
- ``CyclicRows`` against ``torch.roll`` and its backward; an H that does
  not divide raises, naming the factor; the posterior sample draws the
  whole latent's noise; a whole 128x128 request banded
  (``spatial_parallel_request``) against ``SwinIRPipeline.run`` in one
  process; without a process group every wrapper is the plain model, bit
  for bit.

Limits: fp32, TOL x max|ref| for outputs, GRAD_TOL x max|ref| for the
gradient, as the other parallel tests. Measured on the CPU (x max|ref|):
the banded models 7.9e-7-1.2e-6 from JAX's single-device output and from
its spatial_parallel output (which reads 0-9.3e-7 from its own
single-device one), TP SwinIR 9.9e-7, the decode's gradient 1.0e-6; the
planted faults 0.11 (every band masked as the last), 0.18 (the open roll)
and 0.29 (the halo row from above).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from diffbir_tpu.models.bsrnet import RRDBNet as JaxRRDBNet
from diffbir_tpu.models.scunet import SCUNet as JaxSCUNet
from diffbir_tpu.models.swinir import SwinIR as JaxSwinIR
from diffbir_tpu.models.vae import AutoencoderKL as JaxVAE
from diffbir_tpu.parallel import inference as jax_inference
from diffbir_tpu.parallel.mesh import make_mesh
from diffbir_tpu.parallel.tp import tp_spec
from diffbir_tpu_torch.models.bsrnet import RRDBNet
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.models.layers import random_init_
from diffbir_tpu_torch.models.scunet import SCUNet
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.models.vae import AutoencoderKL
from diffbir_tpu_torch.ops import attention as attention_mod
from diffbir_tpu_torch.ops import flash_attention as port_flash
from diffbir_tpu_torch.parallel import collectives, distributed, inference, tp
from diffbir_tpu_torch.pipeline import SwinIRPipeline
from diffbir_tpu_torch.schedule import Schedule
from diffbir_tpu_torch.weights.convert import flax_to_state_dict
from tests.test_torch_models import fill_params
from tests.test_torch_parallel import WORLD, free_port, spawn, start_group
from tests.test_torch_parallel_inference import _err, _jax_leaves, _limit

TOL, GRAD_TOL = 1e-5, 5e-5
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)  # ControlLDM.tiny's
SWIN_KW = dict(embed_dim=24, depths=(2, 2), num_heads=(6, 6), window_size=8)
SCU_KW = dict(config=(2, 1, 1, 2, 1, 1, 2), dim=16, head_dim=8)
RRDB_KW = dict(nf=8, nb=2, gc=4)
SHIFTS = (-3, -1, 1, 3)
REQ_STEPS = 2
# the cases held against JAX: (model, input) NHWC
CASES = ("encode", "decode", "swinir", "swinir_one_row", "scunet", "bsrnet")


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------------------- #
# the data, shared by the processes through one file
# --------------------------------------------------------------------------- #
def _tree(module, shape, seed):
    return fill_params(jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(shape)),
                       seed=seed)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = {"trees": {}, "sd": {}, "x": {}}
    jvae = JaxVAE(**VAE_KW)
    d["trees"]["vae"] = fill_params(jax.eval_shape(
        jvae.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))), seed=1)
    d["trees"]["swinir"] = _tree(JaxSwinIR(**SWIN_KW), (1, 64, 64, 3), 2)
    d["trees"]["scunet"] = _tree(JaxSCUNet(**SCU_KW), (1, 64, 64, 3), 3)
    d["trees"]["bsrnet"] = _tree(JaxRRDBNet(**RRDB_KW, sf=4), (1, 16, 16, 3), 4)
    d["sd"] = {k: flax_to_state_dict(v) for k, v in d["trees"].items()}
    d["x"] = {"encode": (rng.random((1, 64, 48, 3)) * 2 - 1).astype(np.float32),
              "decode": rng.standard_normal((1, 8, 6, 4)).astype(np.float32),
              "swinir": rng.random((1, 256, 128, 3)).astype(np.float32),
              "swinir_one_row": rng.random((1, 128, 192, 3)).astype(np.float32),
              "scunet": rng.random((1, 128, 96, 3)).astype(np.float32),
              "bsrnet": rng.random((1, 16, 12, 3)).astype(np.float32),
              "cotangent": rng.standard_normal((1, 64, 48, 3)).astype(np.float32),
              "rows": rng.standard_normal((1, 8, 5, 3)).astype(np.float32),
              "lq": rng.integers(0, 256, (1, 128, 128, 3), dtype=np.uint8),
              "x_T": rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
              "noise": rng.standard_normal((REQ_STEPS, 1, 16, 16, 4)).astype(np.float32)}
    path = str(tmp_path_factory.mktemp("parallel_models") / "data.pt")
    torch.save({"sd": d["sd"], "x": d["x"]}, path)
    d["path"] = path
    return d


# --------------------------------------------------------------------------- #
# the port's models and runs (in each process, and in one)
# --------------------------------------------------------------------------- #
def port_models(sd) -> dict:
    out = {"vae": AutoencoderKL(**VAE_KW), "swinir": SwinIR(**SWIN_KW),
           "scunet": SCUNet(**SCU_KW), "bsrnet": RRDBNet(**RRDB_KW, sf=4)}
    for k, m in out.items():
        m.load_state_dict(sd[k], strict=True)
        m.eval()
    return out


def request_pipe() -> SwinIRPipeline:
    """A tiny SwinIR pipeline, random weights from seed 7."""
    gen = torch.Generator().manual_seed(7)
    cldm = random_init_(ControlLDM.tiny(), gen).eval()
    swin = random_init_(SwinIR(**SWIN_KW), gen).eval()
    return SwinIRPipeline(swin, cldm, Schedule.v21(), torch.device("cpu"), min_cond_size=64)


def request_kwargs(x) -> dict:
    return dict(steps=REQ_STEPS, cfg_scale=4.0, pos_prompt="", neg_prompt="",
                sampler_type="edm_dpm++_3m_sde", x_T=torch.from_numpy(x["x_T"]),
                noise_table=torch.from_numpy(x["noise"]))


def _cleaner(name):
    return "swinir" if name.startswith("swinir") else name


@torch.no_grad()
def sp_run(m: dict, x: dict, case: str) -> np.ndarray:
    """The banded ``case`` on this process's band of its input, gathered
    (NHWC)."""
    band = inference.spatial_shard(torch.from_numpy(x[case]))
    if case in ("encode", "decode"):
        vae = inference.spatial_parallel(m["vae"])
        band = band.permute(0, 3, 1, 2)
        out = torch.cat(vae.encode_moments(band), dim=1) if case == "encode" else vae.decode(band)
        out = out.permute(0, 2, 3, 1)
    else:
        out = inference.spatial_parallel(m[_cleaner(case)])(band)
    return inference.gather(out).numpy()


def decode_grad(vae, x) -> np.ndarray:
    """d sum(decode(z) * cotangent) / dz of this band, gathered (NHWC)."""
    fn = inference.spatial_parallel(vae)
    z = inference.spatial_shard(torch.from_numpy(x["decode"])).permute(0, 3, 1, 2)
    z = z.contiguous().requires_grad_()
    w = inference.spatial_shard(torch.from_numpy(x["cotangent"])).permute(0, 3, 1, 2)
    (fn.decode(z) * w).sum().backward()
    return _nhwc(inference.gather(z.grad.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))


def open_roll(y, group, shift):
    """The roll without its wrap: zeros where the rows of the image's other
    end should enter."""
    out = _real_roll(y, group, shift)
    n, rank = inference._world(group)
    s = abs(shift)
    if shift < 0 and rank == n - 1:
        return torch.cat([out[:, :-s], torch.zeros_like(out[:, -s:])], dim=1)
    if shift > 0 and rank == 0:
        return torch.cat([torch.zeros_like(out[:, :s]), out[:, s:]], dim=1)
    return out


def last_band(h, group):
    """Every band's mask rows taken as the last band's."""
    n, _ = inference._world(group)
    return _real_band(h, group)._replace(row0=(n - 1) * h)


def row_above(x, group):
    """The Downsample's halo row from the band above (zeros over the first)."""
    return inference._halo_rows(x, group, below=False)[0]


_real_roll, _real_band = inference._roll_rows, inference._band
FAULTS = {"fault_open_roll": ("_roll_rows", open_roll, "swinir"),
          "fault_last_band_mask": ("_band", last_band, "swinir"),
          "fault_row_above": ("_row_below", row_above, "encode")}


def raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def worker(rank, port, path, out_dir):
    start_group(rank, port)
    try:
        d = torch.load(path, weights_only=False)
        x, out = d["x"], {}
        m = port_models(d["sd"])
        out["sp"] = {case: sp_run(m, x, case) for case in CASES}
        out["decode_grad"] = decode_grad(m["vae"], x)
        for name, (attr, fault, case) in FAULTS.items():
            real = getattr(inference, attr)
            setattr(inference, attr, fault)
            try:
                out[name] = sp_run(m, x, case)
            finally:
                setattr(inference, attr, real)
        band = inference.spatial_shard(torch.from_numpy(x["rows"])).requires_grad_()
        with torch.no_grad():
            out["roll"] = {s: inference.gather(collectives.CyclicRows.apply(band, None, s, 1))
                           for s in SHIFTS}
        weight = torch.arange(band.numel(), dtype=torch.float32).reshape(band.shape)
        (collectives.CyclicRows.apply(band, None, -3, 1) * weight).sum().backward()
        out["roll_grad"] = inference.gather(band.grad)
        with torch.no_grad():
            sw = inference.spatial_parallel(m["swinir"])
            vae = inference.spatial_parallel(m["vae"])
            out["odd"] = {
                "swinir": raises(lambda: sw(torch.zeros(1, 96, 64, 3))),
                "scunet": raises(lambda: inference.spatial_parallel(m["scunet"])(
                    torch.zeros(1, 48, 64, 3))),
                "encode": raises(lambda: vae.encode_moments(torch.zeros(1, 3, 20, 16))),
                "bsrnet": raises(lambda: inference.spatial_shard(torch.zeros(1, 15, 8, 3)))}
            pipe = request_pipe()
            fn = inference.spatial_parallel(pipe.cldm)
            img = inference.spatial_shard(torch.from_numpy(x["encode"][:, :, :32]))
            out["sample"] = inference.gather(fn.vae_encode(
                img, generator=torch.Generator().manual_seed(5)))
            out["request"] = inference.spatial_parallel_request(pipe, x["lq"],
                                                                **request_kwargs(x))
            tp.tp_shard_(m["swinir"])
            out["tp_swinir"] = m["swinir"](torch.from_numpy(x["swinir"])).numpy()
            out["tp_shapes"] = {k: tuple(v.shape) for k, v in m["swinir"].state_dict().items()}
            out["tp_splits"] = m["swinir"].layers[0].residual_group.blocks[0].attn.qkv.weight \
                .tp_splits
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown_distributed()


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    spawn(worker, free_port(), data["path"], out_dir)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


# --------------------------------------------------------------------------- #
# the JAX references (jitted once)
# --------------------------------------------------------------------------- #
def _jax_fns() -> dict:
    """{case: fn(params, x NHWC)} of the JAX package."""
    vae = JaxVAE(**VAE_KW)
    swin, scu, rrdb = JaxSwinIR(**SWIN_KW), JaxSCUNet(**SCU_KW), JaxRRDBNet(**RRDB_KW, sf=4)
    return {"encode": lambda p, x: jnp.concatenate(
                vae.apply(p, x, method=vae.encode_moments), axis=-1),
            "decode": lambda p, z: vae.apply(p, z, method=vae.decode),
            "swinir": swin.apply, "swinir_one_row": swin.apply, "scunet": scu.apply,
            "bsrnet": rrdb.apply}


def _tree_of(case: str) -> str:
    return "vae" if case in ("encode", "decode") else _cleaner(case)


@pytest.fixture(scope="module")
def jax_refs(data):
    fns, x = _jax_fns(), data["x"]
    mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    rep, band = NamedSharding(mesh, P()), jax_inference.spatial_shard(mesh)
    refs = {"one": {}, "sp": {}}
    for case, fn in fns.items():
        tree = data["trees"][_tree_of(case)]
        refs["one"][case] = np.asarray(jax.jit(fn)(tree, x[case]))
        sp = jax_inference.spatial_parallel(fn, mesh)
        refs["sp"][case] = np.asarray(sp(jax.device_put(tree, rep),
                                         jax.device_put(x[case], band)))
    tree = data["trees"]["vae"]
    refs["decode_grad"] = np.asarray(jax.jit(jax.grad(
        lambda z: jnp.sum(fns["decode"](tree, z) * x["cotangent"])))(x["decode"]))
    return refs


# --------------------------------------------------------------------------- #
# the route of the VAE's d = 512 attention on a band
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("skv,grad,route", [
    (attention_mod.FLASH_MIN_WIDE, False, "flash"),
    (attention_mod.FLASH_MIN_WIDE // 2, False, "plain"),
    (attention_mod.FLASH_MIN_WIDE_GRAD, True, "flash"),
    (attention_mod.FLASH_MIN_WIDE_GRAD // 2, True, "plain")])
def test_kv_gathered_wide_attention_takes_the_whole_images_route(monkeypatch, skv, grad,
                                                                  route):
    """A band's d = 512 call (q: the band's Skv / 2 tokens, k and v gathered)
    takes the route of the whole image's call in one process: the
    thresholds read Skv. The parent read Sq, so the 512x512 image's band
    (2048 queries against 4096 kv rows) took plain math where one process
    took K1_wide. Both callees are counted, not run."""
    calls = []
    monkeypatch.setattr(port_flash, "flash_attention",
                        lambda q, k, v: calls.append("flash") or torch.empty_like(q))
    monkeypatch.setattr(attention_mod, "plain_attention",
                        lambda q, k, v, **kw: calls.append("plain") or torch.empty_like(q))
    whole = torch.empty(1, skv, 1, 512, device="meta").requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        attention_mod.attention(whole, whole, whole)
        attention_mod.attention(whole[:, : skv // 2], whole, whole, kv_gathered=True)
    assert calls == [route, route]


# --------------------------------------------------------------------------- #
# tensor-parallel SwinIR
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [2, 4])
def test_tp_dim_matches_jax_tp_spec_on_swinir_and_scunet(data, n):
    """tp_dim is tp_spec on every leaf of SwinIR's and SCUNet's trees:
    SwinIR's qkv and mlp.fc1 column, proj and mlp.fc2 row; nothing of
    SCUNet (embedding_layer, linear and its mlp.0/mlp.2 match no suffix)."""
    sharded = {}
    for model in ("swinir", "scunet"):
        for name, arr, leaf, path in _jax_leaves(data["trees"][model]):
            spec = tp_spec(path, leaf, n)
            axis = next((i for i, a in enumerate(spec) if a == "tensor"), None)
            want = None if axis is None else {leaf.ndim - 1: 0, leaf.ndim - 2: 1}[axis]
            got = tp.tp_dim(name, torch.from_numpy(np.ascontiguousarray(arr)), n)
            assert got == want, name
            if got is not None:
                sharded[name] = (model, got)
    assert {m for m, _ in sharded.values()} == {"swinir"}
    leaves = ("attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight", "mlp.fc2.weight")
    assert all(k.endswith(leaves) for k in sharded)
    assert all(any(k.endswith(leaf) for k in sharded) for leaf in leaves)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_plan_of_swinir(n):
    """The win unit shards qkv in matching q/k/v slices ("qkv"), proj by
    rows and the bias table by whole heads where the 6 heads divide (2
    processes, not 4: "heads"); the swin_mlp unit pairs fc1 with fc2.
    SCUNet stays replicated."""
    swin = SwinIR(**SWIN_KW, device="meta")
    plan = tp.tp_plan(swin, n)
    pre = "layers.0.residual_group.blocks.1."
    heads = n == 2
    assert plan[pre + "attn.qkv.weight"] == ((0, "qkv") if heads else (None, "heads"))
    assert plan[pre + "attn.qkv.bias"] == ((0, "qkv") if heads else (None, "replicated"))
    assert plan[pre + "attn.proj.weight"] == ((1, "row") if heads else (None, "heads"))
    assert plan[pre + "attn.relative_position_bias_table"] == (
        (1, "heads") if heads else (None, "replicated"))
    assert plan[pre + "mlp.fc1.weight"] == (0, "col")
    assert plan[pre + "mlp.fc2.weight"] == (1, "row")
    assert all(r in tp.REASONS for _, r in plan.values())
    scu = tp.tp_plan(SCUNet(**SCU_KW, device="meta"), n)
    assert {r for _, r in scu.values()} == {"replicated"}


def test_tp_swinir_matches_jax(ranks, jax_refs):
    """tp_shard_(swinir) at 2 processes (3 heads a process) computes what
    the whole model does."""
    ref = jax_refs["one"]["swinir"]
    for r in ranks:
        assert _err(r["tp_swinir"], ref) <= _limit(ref)
    shapes = ranks[0]["tp_shapes"]
    pre = "layers.1.residual_group.blocks.0."
    assert shapes[pre + "attn.qkv.weight"] == (36, 24)
    assert shapes[pre + "attn.proj.weight"] == (24, 12)
    assert shapes[pre + "attn.relative_position_bias_table"] == (225, 3)
    assert shapes[pre + "mlp.fc1.weight"] == (24, 24)
    assert shapes[pre + "mlp.fc2.weight"] == (24, 24)
    assert ranks[0]["tp_splits"] == 3


# --------------------------------------------------------------------------- #
# spatial-parallel
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", CASES)
def test_sp_matches_jax_single_device_and_spatial_parallel(ranks, jax_refs, case):
    for ref in (jax_refs["one"][case], jax_refs["sp"][case]):
        for r in ranks:
            assert r["sp"][case].shape == ref.shape
            assert _err(r["sp"][case], ref) <= _limit(ref), case


def test_sp_decode_gradient_matches_jax_grad(ranks, jax_refs):
    ref = jax_refs["decode_grad"]
    for r in ranks:
        assert _err(r["decode_grad"], ref) <= GRAD_TOL * float(np.abs(ref).max())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_limit(ranks, jax_refs, fault):
    ref = jax_refs["one"][FAULTS[fault][2]]
    assert _err(ranks[0][fault], ref) > 100 * _limit(ref)


@pytest.mark.parametrize("shift", SHIFTS)
def test_cyclic_rows_is_the_whole_images_roll(ranks, data, shift):
    ref = torch.roll(torch.from_numpy(data["x"]["rows"]), shift, dims=1)
    for r in ranks:
        assert torch.equal(r["roll"][shift], ref)


def test_cyclic_rows_backward_is_the_opposite_roll(ranks, data):
    n = data["x"]["rows"].size // WORLD
    weight = torch.cat([torch.arange(n, dtype=torch.float32).reshape(1, 4, 5, 3)] * WORLD, 1)
    ref = torch.roll(weight, 3, dims=1)
    for r in ranks:
        assert torch.equal(r["roll_grad"], ref)


@pytest.mark.parametrize("model,factor", [("swinir", "64 x 2 processes = 128"),
                                          ("scunet", "64 x 2 processes = 128"),
                                          ("encode", "8 x 2 processes = 16"),
                                          ("bsrnet", "over 2 processes")])
def test_an_h_that_does_not_divide_raises(ranks, model, factor):
    assert factor in ranks[0]["odd"][model], ranks[0]["odd"][model]


def test_posterior_sample_takes_the_whole_latents_noise(ranks, data):
    """A banded posterior sample equals one process's from the same
    generator: the noise is drawn for the whole latent, then banded."""
    pipe = request_pipe()
    img = torch.from_numpy(data["x"]["encode"][:, :, :32])
    with torch.no_grad():
        ref = pipe.cldm.vae_encode(img, generator=torch.Generator().manual_seed(5))
    for r in ranks:
        assert r["sample"].shape == ref.shape
        assert _err(r["sample"], ref) <= _limit(ref)


def test_banded_request_matches_one_process(ranks, data):
    """SwinIR -> encode -> 2 steps of edm_dpm++_3m_sde at CFG 4 -> decode ->
    gather -> colour fix, banded over the two processes, against
    SwinIRPipeline.run on the same x_T and noise table: within 1 LSB."""
    pipe = request_pipe()
    ref = pipe.run(data["x"]["lq"], **request_kwargs(data["x"]))
    for r in ranks:
        assert r["request"].shape == ref.shape == (1, 128, 128, 3)
        assert np.abs(r["request"].astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(ranks[0]["request"], ranks[1]["request"])


# --------------------------------------------------------------------------- #
# without a process group
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["encode", "decode", "swinir", "scunet", "bsrnet"])
@torch.no_grad()
def test_without_a_process_group_each_wrapper_is_the_plain_model(data, case):
    import torch.distributed as dist

    assert not dist.is_initialized()
    m = port_models(data["sd"])
    x = data["x"]
    if case in ("encode", "decode"):
        vae, fn = m["vae"], inference.spatial_parallel(m["vae"])
        if case == "encode":
            img = _nchw(x["encode"])
            assert all(torch.equal(a, b) for a, b in zip(fn.encode_moments(img),
                                                        vae.encode_moments(img)))
        else:
            z = _nchw(x["decode"])
            assert torch.equal(fn.decode(z), vae.decode(z))
        cldm = request_pipe().cldm
        sp = inference.spatial_parallel(cldm)
        img = torch.from_numpy(x["encode"])
        assert torch.equal(sp.vae_encode(img, sample=False), cldm.vae_encode(img, sample=False))
        z = torch.from_numpy(x["decode"])
        assert torch.equal(sp.vae_decode(z), cldm.vae_decode(z))
    else:
        inp = torch.from_numpy(x[case])
        assert torch.equal(inference.spatial_parallel(m[case])(inp), m[case](inp))
