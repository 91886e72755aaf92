"""``parallel/inference.py`` and ``parallel/tp.py`` on two CPU processes
over gloo, against the JAX package's functions.

One spawn of two processes (``tests/test_torch_parallel.py``'s ``launch``
and ``join``, under its timeout, through the DIFFBIR_* launch contract)
computes every case; the JAX references are jitted once for the module, on
the conftest's 8 virtual devices, while the processes run, and the weights
come from JAX trees through ``flax_to_state_dict``:

- ``tp_dim`` against JAX's ``tp_spec`` on every leaf of
  ``ControlLDM.tiny``'s tree at 2 and 4 processes, and where ``tp_plan``
  places a leaf otherwise, that the reason is one of the listed ones
  (whole heads, whole GroupNorm groups, pairs; GEGLU's interleaved slices);
- the tensor-parallel forward: the UNet of
  ``test_tensor_parallel_unet_matches_replicated`` (its config, params +
  0.01) against JAX's unsharded ``apply``, the tiny ControlLDM with and
  without its hoisted tables against JAX's forward, and its CLIP tower
  against JAX's ``encode_text``;
- the spatial-parallel forward of ``ControlLDM.tiny`` at 32x32 (as
  ``test_spatial_parallel_forward_exact``) against JAX's single-device
  output and its ``spatial_parallel`` output; an H that does not divide
  raises;
- ``make_tile_sharded_fn`` (a conv at 64x56, ``up2`` at 48x48, and a
  9-tile case with weight "ones", odd at 2 processes) against JAX's;
- ``tile_parallel_model_fn`` inside ``make_tiled_fn`` against the
  unsharded function, bit for bit;
- batch-parallel: a tiny ``IdentityCleanerPipeline`` request on 2 rows,
  one a process (rank 1 starting from other weights, which the broadcast
  replaces), against one process on both;
- three planted faults (spatial-parallel with zeroed halos, with GroupNorm
  statistics kept local; tensor-parallel without the row layers'
  all-reduce) that must fail the limits;
- the serving modes "fused" (K6, K7, packed K3) and "int8" (K4, K6 on int8
  convs, packed K3) under TP (batch 2 at 8x8, with and without hoisting)
  and SP (32x32), each against one process of the port in the mode, JAX's
  unsharded apply in the mode and JAX's ``tp_shard_params`` or
  ``spatial_parallel`` apply in the mode (``DIFFBIR_TPU_FUSED_FFN=1``,
  ``DIFFBIR_TPU_FLASH_LAYOUT=packed``; JAX's int8 mode on its
  ``quantize_dense_params`` + ``quantize_conv_params`` tree, the port's
  ``set_mode("int8")`` quantising the same float weights bit-equal to it);
  the fused mode's gradient with respect to x under SP against
  ``jax.grad``; a planted fault (SP in the fused mode with K6 on the band
  alone, without the gather) that must fail the limit; the packed rule
  under ``kv_gathered`` reading the whole image's tokens;
- without a process group every wrapper is the plain run, bit for bit.

Limits: fp32 throughout, TOL x max|ref| (gradients GRAD_TOL). The processes
sum partial products, band statistics and canvases in another order than
one process (and JAX), so GSPMD's bit-equality does not carry over.
Measured on the CPU: tensor-parallel 6.2e-7-1.2e-6, spatial 1.2e-6-1.3e-6
(JAX's own spatial_parallel output is 1.0e-6 from its single-device one),
tiles below 1.3e-7; the planted faults 8.7e-2 (local GroupNorm
statistics), 0.20 (no row reduce) and 0.56 (zeroed halos). The fused mode
under TP and SP 8.8e-7-1.5e-6 from one process and JAX (JAX's own sharded
runs 1.0e-6 from its unsharded ones), its SP gradient 1.5e-6-1.9e-6 from
``jax.grad``; K6 on the band alone 0.44. The int8 mode is held within
``test_torch_modes.py``'s int8 forward limit, INT8_TOL x max(1, max|ref|):
K4 rounds every activation to bf16 before its product, and fp32 sums taken
in another order put some elements on the other side of a bf16 rounding
step. Measured 3.9e-3-5.8e-3 x max|ref| from JAX (JAX's own SP run 3.9e-3
from its unsharded one) and 4.4e-3 from one process under SP; under TP,
which shards only the CLIP tower in this mode, 0 from one process.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from diffbir_tpu.models import cldm as jax_cldm
from diffbir_tpu.models.unet import UNetModel as JaxUNet
from diffbir_tpu.parallel import inference as jax_inference
from diffbir_tpu.parallel.mesh import make_mesh
from diffbir_tpu.parallel.tp import tp_shard_params, tp_spec
from diffbir_tpu_torch import tiling
from diffbir_tpu_torch.models.cldm import SERVING_MODES, ControlLDM
from diffbir_tpu_torch.models.layers import random_init_
from diffbir_tpu_torch.models.unet import ResBlock, UNetModel
from diffbir_tpu_torch.ops import attention as port_attention
from diffbir_tpu_torch.ops import flash_attention as port_flash
from diffbir_tpu_torch.parallel import distributed, inference, tp
from diffbir_tpu_torch.pipeline import IdentityCleanerPipeline, build_sampler
from diffbir_tpu_torch.schedule import Schedule
from diffbir_tpu_torch.weights.convert import convert_leaf, flax_to_state_dict
from tests.test_torch_models import fill_params
from tests.test_torch_parallel import WORLD, free_port, join, launch, start_group

TOL = 1e-5
GRAD_TOL = 5e-5
# test_torch_modes.py's int8 forward limit, x max(1, max|ref|)
INT8_TOL = 1e-2
# the serving modes as the JAX package's flags and environment (the port:
# ControlLDM.set_mode)
MODES = ("fused", "int8")
JAX_MODE_KW = {"fused": dict(fused_resblock=True),
               "int8": dict(quant_dense=True, fused_resblock=True, quant_conv=True)}
JAX_MODE_ENV = {"DIFFBIR_TPU_FUSED_FFN": "1", "DIFFBIR_TPU_FLASH_LAYOUT": "packed"}
UNET_KW = dict(model_channels=32, num_head_channels=16, channel_mult=(1, 2),
               attention_resolutions=(2, 1), context_dim=64)
SP_HW = 32
STEPS, CFG = 2, 4.0
GRID = build_sampler("edm_dpm++_3m_sde", Schedule.v21(), False).model_ts(10)


def _limit(ref, mode: str = "default") -> float:
    top = float(np.abs(np.asarray(ref)).max())
    return INT8_TOL * max(1.0, top) if mode == "int8" else TOL * top


def _err(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max())


# --------------------------------------------------------------------------- #
# the data, shared by the processes through one file
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Weights (JAX trees and their state dicts) and inputs of every case."""
    rng = np.random.default_rng(0)
    d = {}
    # the UNet of test_tensor_parallel_unet_matches_replicated
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(np.float32)
    t = np.array([10.0, 600.0], np.float32)
    unet = JaxUNet(**UNET_KW)
    params = jax.jit(unet.init)(jax.random.PRNGKey(0), x, t, ctx)
    params = jax.device_get(jax.tree_util.tree_map(lambda a: a + 0.01, params))
    d["unet"] = dict(tree=params, sd=flax_to_state_dict(params), x=x, t=t, ctx=ctx)
    # the tiny ControlLDM: TP (batch 2 at 8x8, hoisted) and SP (32x32)
    tree = fill_params(jax_cldm.ControlLDM.tiny().eval_shapes((8, 8)), seed=0)
    d["cldm"] = dict(tree=tree, sd=flax_to_state_dict(tree))
    d["tp"] = dict(x=rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
                   c_img=rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
                   ctx=rng.standard_normal((2, 77, 64)).astype(np.float32),
                   t=np.full((2,), float(GRID[3]), np.float32),
                   tokens=np.concatenate([[[49406], [49406]], rng.integers(1, 49406, (2, 6)),
                                          [[49407], [49407]], np.zeros((2, 69), int)],
                                         axis=1).astype(np.int64))
    d["sp"] = dict(x=np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, SP_HW, SP_HW, 4))),
                   c_img=rng.standard_normal((1, SP_HW, SP_HW, 4)).astype(np.float32),
                   ctx=np.full((1, 77, 64), 0.1, np.float32), t=np.full((1,), 500.0, np.float32),
                   w=rng.standard_normal((1, SP_HW, SP_HW, 4)).astype(np.float32))
    # the tile cases
    d["tiles"] = dict(k=(np.random.default_rng(0).standard_normal((3, 3, 3, 3)) * 0.2)
                      .astype(np.float32),
                      conv=np.random.default_rng(1).random((1, 64, 56, 3)).astype(np.float32),
                      up2=np.random.default_rng(2).random((1, 48, 48, 3)).astype(np.float32),
                      ones=np.random.default_rng(3).random((1, 40, 40, 3)).astype(np.float32),
                      model=rng.random((1, 32, 32, 4)).astype(np.float32))
    # the batch-parallel request: 2 rows, x_T and the sampler's draws for both
    d["batch"] = dict(lq=rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
                      x_T=torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32)),
                      noise=torch.from_numpy(rng.standard_normal((STEPS, 2, 8, 8, 4))
                                             .astype(np.float32)))
    path = str(tmp_path_factory.mktemp("parallel_inference") / "data.pt")
    torch.save({k: {n: a for n, a in v.items() if n != "tree"} for k, v in d.items()}, path)
    d["path"] = path
    return d


# --------------------------------------------------------------------------- #
# the port's runs (in each process, and in one)
# --------------------------------------------------------------------------- #
def tiny_cldm(sd, **modes):
    m = ControlLDM.tiny(**modes)
    m.load_state_dict(sd, strict=True)
    return m.eval()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def conv_fn(k):
    w = _t(k).permute(3, 2, 0, 1)  # HWIO -> OIHW

    def conv(x):
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)

    return conv


def up2(x):
    return (x * 1.5).repeat_interleave(2, 1).repeat_interleave(2, 2)


def tile_cases(tiles):
    """{name: (fn, input, make_tiled_fn-style arguments)}."""
    conv = conv_fn(tiles["k"])
    return {"conv": (conv, tiles["conv"], dict(size=16, stride=8)),
            "up2": (up2, tiles["up2"], dict(size=16, stride=8, scale_type="up", scale=2)),
            "ones": (conv, tiles["ones"], dict(size=16, stride=12, weight="ones"))}


def model_tiles(x_tiles):
    return x_tiles * 2.0 + 1.0


def model_tiles_coords(x_tiles, tile_coords=()):
    k = len(tile_coords)
    per = torch.tensor([hi * 100 + wi for hi, wi in tile_coords], dtype=x_tiles.dtype)
    return x_tiles * 2.0 + per.repeat_interleave(x_tiles.shape[0] // k)[:, None, None, None]


def tile_parallel_runs(x, wrap):
    """make_tiled_fn over ``wrap``ped models: tiles of 8 over 32x32 (16
    tiles) in calls of 16, and in calls of 3 (the last of 1) with coords."""
    return {"16": tiling.make_tiled_fn(wrap(model_tiles), 8, 8, tiles_per_batch=16)(x),
            "3": tiling.make_tiled_fn(wrap(model_tiles_coords), 8, 8, tiles_per_batch=3)(x)}


def batch_request(pipe, rows):
    return pipe.run(rows["lq"], steps=STEPS, cfg_scale=CFG, neg_prompt="",
                    sampler_type="edm_dpm++_3m_sde", x_T=rows["x_T"], noise_table=rows["noise"])


def sp_run(cldm, sp):
    fn = inference.spatial_parallel(cldm)
    cond = {"c_txt": _t(sp["ctx"]), "c_img": inference.spatial_shard(_t(sp["c_img"]))}
    return inference.gather(fn(inference.spatial_shard(_t(sp["x"])), _t(sp["t"]), cond))


def sp_grad(cldm, sp):
    """The gradient of sum(w * the denoiser's output) with respect to x,
    spatial-parallel (each band's loss on its band), gathered."""
    fn = inference.spatial_parallel(cldm)
    x = inference.spatial_shard(_t(sp["x"])).clone().requires_grad_(True)
    cond = {"c_txt": _t(sp["ctx"]), "c_img": inference.spatial_shard(_t(sp["c_img"]))}
    (fn(x, _t(sp["t"]), cond) * inference.spatial_shard(_t(sp["w"]))).sum().backward()
    return inference.gather(x.grad)


def k6_on_the_band_alone(m, group, x, emb, emb_out=None):
    """The planted fault: K6 on this band's rows, without the gather (no
    halo rows, the band's own GroupNorm statistics)."""
    return ResBlock.forward(m, x, emb, emb_out)


def mode_runs(sd, mode, d):
    """The tiny ControlLDM in ``mode`` (``set_mode``: the int8 weights
    quantised in place from the float ones, bit-equal to JAX's quantised
    tree): SP, in the fused mode also its x-gradient and the planted fault,
    then TP (tp_shard_ shards in place): {name: output}."""
    cldm = tiny_cldm(sd).set_mode(mode)
    out = {"sp": sp_run(cldm, d["sp"])}
    if mode == "fused":
        with torch.enable_grad():
            out["grad"] = sp_grad(cldm, d["sp"])
        real = inference._band_fused_resblock
        inference._band_fused_resblock = k6_on_the_band_alone
        try:
            out["fault_band_alone"] = sp_run(cldm, d["sp"])
        finally:
            inference._band_fused_resblock = real
    tp.tp_shard_(cldm)
    out["tp"] = tp_runs(cldm, d["tp"])
    out["tp_weights"] = sum(t.numel() for _, t in tp._weights(cldm))
    return out


def tp_runs(cldm, d):
    """The sharded tiny ControlLDM's forward, and through hoisted tables
    made after the sharding."""
    cond = {"c_txt": _t(d["ctx"]), "c_img": _t(d["c_img"])}
    x, t = _t(d["x"]), _t(d["t"])
    tables = cldm.make_hoist_tables(cond["c_txt"], GRID)
    return {"plain": cldm(x, t, cond), "hoisted": cldm(x, t, cond,
                                                       hoisted=tables.lookup(float(t[0])))}


def unet_run(unet, u):
    out = unet(_t(u["x"]).permute(0, 3, 1, 2), _t(u["t"]), _t(u["ctx"]))
    return out.permute(0, 2, 3, 1)


def local_moments(xf, group):
    axes = tuple(range(2, xf.dim()))
    mean = xf.mean(dim=axes, keepdim=True)
    return mean, ((xf - mean) ** 2).mean(dim=axes, keepdim=True)


def zero_halos(x, group, below):
    zero = torch.zeros_like(x[:, :, :1])
    return zero, zero if below else None


def raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


@torch.no_grad()
def worker(rank, port, path, out_dir):
    start_group(rank, port)
    try:
        d = torch.load(path, weights_only=False)
        out = {}
        # tensor-parallel
        unet = UNetModel(**UNET_KW)
        unet.load_state_dict(d["unet"]["sd"], strict=True)
        tp.tp_shard_(unet.eval())
        out["tp_unet"] = unet_run(unet, d["unet"])
        cldm = tp.tp_shard_(tiny_cldm(d["cldm"]["sd"]))
        out["tp_cldm"] = tp_runs(cldm, d["tp"])
        out["tp_clip"] = cldm.encode_text(_t(d["tp"]["tokens"]))
        proj = cldm.unet.input_blocks[1][1].transformer_blocks[0].ff.net[0].proj
        out["geglu"] = proj.weight.detach()
        out["tp_shapes"] = {k: tuple(v.shape) for k, v in cldm.state_dict().items()}
        real = tp._reduce_partial
        tp._reduce_partial = lambda t, group: t
        try:
            out["fault_no_reduce"] = unet_run(unet, d["unet"])
        finally:
            tp._reduce_partial = real
        # spatial-parallel, its faults, the shape check
        cldm = tiny_cldm(d["cldm"]["sd"])
        out["sp"] = sp_run(cldm, d["sp"])
        for name, attr, fault in (("fault_zero_halos", "_halo_rows", zero_halos),
                                  ("fault_local_gn", "_band_moments", local_moments)):
            real = getattr(inference, attr)
            setattr(inference, attr, fault)
            try:
                out[name] = sp_run(cldm, d["sp"])
            finally:
                setattr(inference, attr, real)
        odd = {k: np.concatenate([v, v[:, :2]], axis=1) if k in ("x", "c_img") else v
               for k, v in d["sp"].items()}  # H 34: bands of 17 rows
        out["sp_odd"] = raises(lambda: sp_run(cldm, odd))
        # the serving modes
        out["modes"] = {mode: mode_runs(d["cldm"]["sd"], mode, d) for mode in MODES}
        # tiles
        out["tile_sharded"] = {
            name: inference.make_tile_sharded_fn(fn, **kw)(_t(x))
            for name, (fn, x, kw) in tile_cases(d["tiles"]).items()}
        out["tile_parallel"] = tile_parallel_runs(
            _t(d["tiles"]["model"]), inference.tile_parallel_model_fn)
        # batch-parallel: rank 1 starts from other weights
        cldm = tiny_cldm(d["cldm"]["sd"])
        if rank:
            random_init_(cldm, torch.Generator().manual_seed(99))
        cldm, rows = inference.shard_for_batch_parallel(cldm, d["batch"],
                                                        batch_axes={"noise": 1})
        pipe = IdentityCleanerPipeline(cldm, Schedule.v21(), torch.device("cpu"),
                                       min_cond_size=64)
        out["batch_rows"] = rows["lq"].shape[0]
        out["batch"] = inference.batch_parallel(lambda r: batch_request(pipe, r))(rows)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown_distributed()


@pytest.fixture(scope="module")
def workers(data, tmp_path_factory):
    """The processes, started; the JAX references are computed while they
    run (``ranks`` joins them)."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    ctx = launch(worker, free_port(), data["path"], out_dir)
    yield ctx, out_dir
    for p in ctx.processes:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def ranks(workers, jax_refs):
    ctx, out_dir = workers
    join(ctx, worker.__name__)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


# --------------------------------------------------------------------------- #
# the JAX references (jitted once)
# --------------------------------------------------------------------------- #
def jax_quantized(tree):
    """JAX's int8 tree: ``quantize_dense_params``, then
    ``quantize_conv_params`` (eager, as ``tests/test_torch_modes.py``)."""
    return jax_cldm.quantize_conv_params(jax_cldm.quantize_dense_params(tree))


def jax_mode_refs(data):
    """{mode: {"sp", "sp_parallel", "tp", "tp_parallel"}}: the JAX model in
    each serving mode, unsharded and on 2 of the virtual devices (SP by
    ``spatial_parallel``, TP by ``tp_shard_params``); "grad", the fused
    mode's x-gradient of sum(w * out) on the SP inputs."""
    s, d = data["sp"], data["tp"]
    mesh_sp = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    mesh_tp = make_mesh(n_data=1, n_tensor=WORLD, devices=jax.devices()[:WORLD])
    rep, band = NamedSharding(mesh_sp, P()), jax_inference.spatial_shard(mesh_sp)
    trees = {"fused": data["cldm"]["tree"],
             "int8": jax.device_get(jax_quantized(data["cldm"]["tree"]))}
    refs = {}
    with mock.patch.dict(os.environ, JAX_MODE_ENV):
        for mode in MODES:
            cldm = jax_cldm.ControlLDM.tiny(**JAX_MODE_KW[mode])
            tree = trees[mode]

            def fwd(p, x, t, ctx, c_img, cldm=cldm):
                return cldm(p, x, t, {"c_txt": ctx, "c_img": c_img})

            def sp_fwd(p, x, c_img, cldm=cldm):
                return cldm(p, x, jax.device_put(s["t"], rep),
                            {"c_txt": s["ctx"],
                             "c_img": jax.lax.with_sharding_constraint(c_img, band)})

            r = refs[mode] = {}
            r["sp"] = np.asarray(jax.jit(fwd)(tree, s["x"], s["t"], s["ctx"], s["c_img"]))
            r["sp_parallel"] = np.asarray(jax_inference.spatial_parallel(sp_fwd, mesh_sp)(
                jax.device_put(tree, rep), jax.device_put(s["x"], band),
                jax.device_put(s["c_img"], band)))
            r["tp"] = np.asarray(jax.jit(fwd)(tree, d["x"], d["t"], d["ctx"], d["c_img"]))
            r["tp_parallel"] = np.asarray(jax.jit(fwd)(tp_shard_params(mesh_tp, tree), d["x"],
                                                       d["t"], d["ctx"], d["c_img"]))
            if mode == "fused":
                r["grad"] = np.asarray(jax.jit(jax.grad(
                    lambda x: jnp.sum(fwd(tree, x, s["t"], s["ctx"], s["c_img"]) * s["w"])))(
                        s["x"]))
    return refs


@pytest.fixture(scope="module")
def jax_refs(data, workers):
    refs = {"modes": jax_mode_refs(data)}
    u = data["unet"]
    refs["unet"] = np.asarray(jax.jit(JaxUNet(**UNET_KW).apply)(u["tree"], u["x"], u["t"],
                                                                 u["ctx"]))
    cldm = jax_cldm.ControlLDM.tiny()
    fwd = jax.jit(lambda p, x, t, ctx, c_img: cldm(p, x, t, {"c_txt": ctx, "c_img": c_img}))
    tree = data["cldm"]["tree"]
    d = data["tp"]
    refs["tp_cldm"] = np.asarray(fwd(tree, d["x"], d["t"], d["ctx"], d["c_img"]))
    refs["tp_clip"] = np.asarray(jax.jit(cldm.encode_text)(tree, d["tokens"]))
    s = data["sp"]
    refs["sp"] = np.asarray(fwd(tree, s["x"], s["t"], s["ctx"], s["c_img"]))
    mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    rep, band = NamedSharding(mesh, P()), jax_inference.spatial_shard(mesh)
    sp = jax_inference.spatial_parallel(
        lambda p, x, c_img: cldm(p, x, jax.device_put(s["t"], rep),
                                 {"c_txt": s["ctx"],
                                  "c_img": jax.lax.with_sharding_constraint(c_img, band)}), mesh)
    refs["sp_jax_parallel"] = np.asarray(sp(jax.device_put(tree, rep),
                                            jax.device_put(s["x"], band),
                                            jax.device_put(s["c_img"], band)))
    mesh8 = make_mesh(n_data=8)
    tiles = data["tiles"]
    k = jnp.asarray(tiles["k"])

    def jconv(x):
        return jax.lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def jup2(x):
        return jnp.repeat(jnp.repeat(x * 1.5, 2, 1), 2, 2)

    jfns = {"conv": jconv, "up2": jup2, "ones": jconv}
    refs["tile_sharded"] = {}
    for name, (_, x, kw) in tile_cases(tiles).items():
        kw = dict(kw)
        size, stride = kw.pop("size"), kw.pop("stride")
        fn = jax_inference.make_tile_sharded_fn(jfns[name], size, stride, mesh8, **kw)
        refs["tile_sharded"][name] = np.asarray(fn(jnp.asarray(x)))
    return refs


# --------------------------------------------------------------------------- #
# tensor-parallel
# --------------------------------------------------------------------------- #
def _jax_leaves(tree):
    """(torch state-dict name, torch-layout array, JAX tensor dim mapped to
    torch's, or None) of every leaf of a JAX tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        keys = tuple(str(getattr(k, "key", k)) for k in path if getattr(k, "key", k) != "params")
        name, arr = convert_leaf(keys, np.asarray(leaf))
        yield name, arr, leaf, path


@pytest.mark.parametrize("n", [2, 4])
def test_tp_dim_matches_jax_tp_spec(data, n):
    """tp_dim is tp_spec on every leaf of ControlLDM.tiny's tree (JAX's
    last axis, output features, is torch's dim 0; its second-to-last is
    torch's dim 1)."""
    seen = 0
    for name, arr, leaf, path in _jax_leaves(data["cldm"]["tree"]):
        spec = tp_spec(path, leaf, n)
        axis = next((i for i, a in enumerate(spec) if a == "tensor"), None)
        want = None if axis is None else {leaf.ndim - 1: 0, leaf.ndim - 2: 1}[axis]
        assert tp.tp_dim(name, torch.from_numpy(np.ascontiguousarray(arr)), n) == want, name
        seen += want is not None
    assert seen > 100


@pytest.mark.parametrize("mode", ["default", *MODES])
@pytest.mark.parametrize("n", [2, 4])
def test_tp_plan_differs_from_jax_only_by_the_listed_rules(data, n, mode):
    """Where tp_plan places a leaf otherwise than tp_dim, the reason is one
    of the explicit forward's rules, at exactly the leaves it names: the
    CLIP tower's out_proj (no column partner: "pair"); at 4 processes the
    2-head attention of the 32-wide blocks ("heads"); the sharded
    ResBlocks' out_layers.0 ("groups"); the column layers' biases, which
    go with their rows. GEGLU's projection is split along tp_dim's
    dimension, in interleaved slices ("geglu"). In the fused mode every
    ResBlock and FFN stays whole ("fused": K6 and K7 read whole weights)
    and attention is sharded by whole heads as in the default mode; in the
    int8 mode every int8 weight of a unit is placed whole ("int8"), as
    tp_dim and JAX's tp_spec on the quantised tree place it, so only the
    CLIP tower shards."""
    cldm = ControlLDM.tiny(**SERVING_MODES[mode], device="meta")
    plan = tp.tp_plan(cldm, n)
    weights = dict(tp._weights(cldm))
    assert set(plan) == set(weights)
    differ = {}
    for name, p in weights.items():
        dim, reason = plan[name]
        assert reason in tp.REASONS
        if dim != tp.tp_dim(name, p, n):
            differ[name] = reason
    pairs = {k for k, r in differ.items() if r == "pair"}
    out_proj = {k for k in weights if k.endswith(".attn.out_proj.weight")}
    assert out_proj and all(k.startswith("clip.") for k in out_proj)
    assert pairs == out_proj
    heads = {k for k, r in differ.items() if r == "heads"}
    narrow = {k for k in heads if ".attn1." in k or ".attn2." in k}
    assert heads == narrow and (len(heads) > 0) == (n == 4 and mode != "int8")
    for k in heads:  # 2 heads of 16: whole heads only at n <= 2
        assert cldm.get_parameter(k).shape[-1 if "to_out" in k else 0] == 32, k
    groups = {k for k, r in differ.items() if r == "groups"}
    assert all(".out_layers.0." in k for k in groups) and bool(groups) == (mode == "default")
    biases = {k for k, r in differ.items() if r in ("col", "geglu")}
    assert all(k.endswith(".bias") for k in biases)
    assert set(differ.values()) <= {"pair", "heads", "groups", "col", "geglu", "fused"}
    geglu = {k for k, (d, r) in plan.items() if r == "geglu" and k.endswith("weight")}
    assert all(k.endswith("ff.net.0.proj.weight") for k in geglu)
    assert bool(geglu) == (mode == "default")
    fused = {k for k, r in differ.items() if r == "fused"}
    res_ff = {k for k, p in weights.items() if tp.tp_dim(k, p, n) is not None and any(
        s in k for s in (".in_layers.2.", ".emb_layers.1.", ".out_layers.3.", ".ff.net."))}
    assert fused == (res_ff if mode == "fused" else set()) and (mode != "fused" or fused)
    int8 = {k for k, (_, r) in plan.items() if r == "int8"}
    assert all(k.endswith(("weight_q", "weight_scale")) and not k.startswith("clip.")
               for k in int8) and bool(int8) == (mode == "int8")
    if mode == "int8":
        assert {k.split(".")[0] for k, (d, _) in plan.items() if d is not None} == {"clip"}
        flat, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
            jax_quantized, data["cldm"]["tree"]))
        assert {_jax_top(path) for path, leaf in flat
                if "tensor" in tp_spec(path, leaf, n)} == {"clip"}


def _jax_top(path) -> str:
    """The submodule ("unet", "clip", ...) of a JAX tree path."""
    return next(str(getattr(k, "key", k)) for k in path if getattr(k, "key", k) != "params")


def test_tp_unet_matches_jax(ranks, data, jax_refs):
    ref = jax_refs["unet"]
    for r in ranks:
        assert _err(r["tp_unet"], ref) <= _limit(ref)
    shapes = ranks[0]["tp_shapes"]
    assert shapes["unet.input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"] == (16, 32)
    assert shapes["unet.input_blocks.1.1.transformer_blocks.0.attn1.to_out.0.weight"] == (32, 16)
    assert shapes["unet.input_blocks.1.0.out_layers.3.weight"] == (32, 16, 3, 3)
    assert shapes["unet.input_blocks.1.0.out_layers.0.weight"] == (16,)


@pytest.mark.parametrize("path", ["plain", "hoisted"])
def test_tp_controlldm_matches_jax(ranks, jax_refs, path):
    ref = jax_refs["tp_cldm"]
    for r in ranks:
        assert _err(r["tp_cldm"][path], ref) <= _limit(ref)


def test_tp_clip_tower_matches_jax(ranks, jax_refs):
    """The CLIP tower with its MLPs sharded (mlp.c_fc with mlp.c_proj)."""
    ref = jax_refs["tp_clip"]
    for r in ranks:
        assert _err(r["tp_clip"], ref) <= _limit(ref)
    assert ranks[0]["tp_shapes"]["clip.transformer.resblocks.0.mlp.c_fc.weight"] == (128, 64)


def test_tp_geglu_takes_matching_slices(ranks, data):
    """Each process's GEGLU projection: its slice of the x half and the
    same slice of the gate half."""
    w = data["cldm"]["sd"]["unet.input_blocks.1.1.transformer_blocks.0.ff.net.0.proj.weight"]
    inner = w.shape[0] // 2
    per = inner // WORLD
    for rank, r in enumerate(ranks):
        rows = np.r_[rank * per:(rank + 1) * per]
        np.testing.assert_array_equal(r["geglu"].numpy(),
                                      np.concatenate([w[rows], w[rows + inner]]))


def test_tp_without_the_row_reduce_fails_the_limit(ranks, jax_refs):
    ref = jax_refs["unet"]
    assert _err(ranks[0]["fault_no_reduce"], ref) > 100 * _limit(ref)


# --------------------------------------------------------------------------- #
# spatial-parallel
# --------------------------------------------------------------------------- #
def test_sp_matches_jax_single_device_and_spatial_parallel(ranks, jax_refs):
    for ref in (jax_refs["sp"], jax_refs["sp_jax_parallel"]):
        for r in ranks:
            assert r["sp"].shape == ref.shape
            assert _err(r["sp"], ref) <= _limit(ref)


@pytest.mark.parametrize("fault", ["fault_zero_halos", "fault_local_gn"])
def test_sp_planted_faults_fail_the_limit(ranks, jax_refs, fault):
    ref = jax_refs["sp"]
    assert _err(ranks[0][fault], ref) > 10 * _limit(ref)


def test_sp_refuses_an_h_that_does_not_divide(ranks):
    msg = ranks[0]["sp_odd"]
    assert "34" in msg and "must divide by 2 x 2 processes = 4" in msg


# --------------------------------------------------------------------------- #
# the serving modes under TP and SP
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def one_process(data):
    """The port's runs of ``mode_runs`` in one process (no process group):
    the plain model in each serving mode."""
    with torch.no_grad():
        return {mode: mode_runs(data["cldm"]["sd"], mode, data) for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["tp", "sp"])
def test_serving_mode_matches_one_process_and_jax(ranks, jax_refs, one_process, kind, mode):
    """tp_shard_ (with and without the hoisted tables) and spatial_parallel
    of the tiny ControlLDM in the mode compute what one process of the port
    computes in it, and what JAX computes in it unsharded and sharded
    (tp_shard_params, spatial_parallel); fused within TOL, int8 within
    INT8_TOL (see the module's notes). Under TP the processes hold fewer
    weights than one process: the fused mode shards attention by heads,
    the int8 mode only the CLIP tower."""
    jref = jax_refs["modes"][mode]
    one = one_process[mode]
    for r in ranks:
        got = r["modes"][mode]
        paths = {"plain": got["tp"]["plain"], "hoisted": got["tp"]["hoisted"]} if kind == "tp" \
            else {"sp": got["sp"]}
        for path, out in paths.items():
            mine = one["tp"][path] if kind == "tp" else one["sp"]
            for label, ref in (("one process", mine), ("JAX", jref[kind]),
                               ("JAX sharded", jref[f"{kind}_parallel"])):
                assert out.shape == ref.shape
                assert _err(out, ref) <= _limit(ref, mode), (path, label)
        if kind == "tp":
            assert got["tp_weights"] < one["tp_weights"]


def test_sp_fused_gradient_matches_jax(ranks, jax_refs, one_process):
    """The fused mode's gradient with respect to x under SP (K6 and K7
    differentiable, the gather's backward a reduce-scatter) against
    jax.grad, as one process's is, within GRAD_TOL x max|ref|."""
    ref = jax_refs["modes"]["fused"]["grad"]
    limit = GRAD_TOL * float(np.abs(ref).max())
    assert _err(one_process["fused"]["grad"], ref) <= limit
    for r in ranks:
        assert _err(r["modes"]["fused"]["grad"], ref) <= limit


def test_sp_fused_k6_on_the_band_alone_fails_the_limit(ranks, jax_refs):
    """The planted fault: K6 on each band alone, without the gather (no
    halo rows, band GroupNorm statistics)."""
    ref = jax_refs["modes"]["fused"]["sp"]
    assert _err(ranks[0]["modes"]["fused"]["fault_band_alone"], ref) > 10 * _limit(ref, "fused")


def test_packed_rule_under_kv_gathered_reads_the_whole_images_tokens(monkeypatch):
    """Under kv_gathered, attention(..., layout="packed") picks K3 by Skv,
    the whole image's tokens: a band of 1536 queries against 3072 gathered
    kv rows takes the packed route (3072 = 3 q blocks of 1024), as one
    process's 3072-token call does; a 1536-token call of its own does not
    (1536 is neither one q block nor whole ones)."""
    calls = []
    real = port_flash.flash_attention

    def recording(q, k, v, prescale_q=False):
        calls.append((q.shape[1], k.shape[1], prescale_q))
        return real(q, k, v, prescale_q=prescale_q)

    monkeypatch.setattr(port_flash, "flash_attention", recording)
    assert port_attention.packed_applies(3072) and not port_attention.packed_applies(1536)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 1536, 2, 64, generator=gen)
    kv = torch.randn(1, 3072, 2, 64, generator=gen)
    band = port_attention.attention(q, kv, kv, layout="packed", kv_gathered=True)
    port_attention.attention(kv, kv, kv, layout="packed")
    port_attention.attention(q, q, q, layout="packed")
    assert calls == [(1536, 3072, True), (3072, 3072, True), (1536, 1536, False)]
    torch.testing.assert_close(band, port_attention.plain_attention(q, kv, kv))


# --------------------------------------------------------------------------- #
# tiles
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["conv", "up2", "ones"])
def test_tile_sharded_matches_jax(ranks, jax_refs, case):
    ref = jax_refs["tile_sharded"][case]
    for r in ranks:
        out = r["tile_sharded"][case]
        assert out.shape == ref.shape
        assert _err(out, ref) <= _limit(ref)


def test_tile_counts_of_the_cases():
    """The cases' tile counts at 2 processes: 42 (even), 25 and 9 (odd)."""
    assert [len(tiling.sliding_windows(h, w, 16, s)) for h, w, s in
            ((64, 56, 8), (48, 48, 8), (40, 40, 12))] == [42, 25, 9]


@pytest.mark.parametrize("calls", ["16", "3"])
def test_tile_parallel_model_fn_equals_unsharded(ranks, data, calls):
    ref = tile_parallel_runs(_t(data["tiles"]["model"]), lambda fn: fn)[calls]
    for r in ranks:
        assert torch.equal(r["tile_parallel"][calls], ref)


# --------------------------------------------------------------------------- #
# batch-parallel
# --------------------------------------------------------------------------- #
def test_batch_parallel_request_matches_one_process(ranks, data):
    """Each process restores its row (the broadcast gave rank 1 rank 0's
    weights) and holds both; one process on both rows within 1 LSB (fp32
    rows at batch 1 and 2 round apart)."""
    pipe = IdentityCleanerPipeline(tiny_cldm(data["cldm"]["sd"]), Schedule.v21(),
                                   torch.device("cpu"), min_cond_size=64)
    with torch.no_grad():
        ref = batch_request(pipe, data["batch"])
    for r in ranks:
        assert r["batch_rows"] == 1
        assert r["batch"].shape == ref.shape == (2, 64, 64, 3)
        assert np.abs(r["batch"].astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(ranks[0]["batch"], ranks[1]["batch"])


# --------------------------------------------------------------------------- #
# without a process group
# --------------------------------------------------------------------------- #
@torch.no_grad()
def test_without_a_process_group_every_wrapper_is_the_plain_run(data):
    import torch.distributed as dist

    assert not dist.is_initialized()
    cldm = tiny_cldm(data["cldm"]["sd"])
    before = {k: v.clone() for k, v in cldm.state_dict().items()}
    assert tp.tp_shard_(cldm) is cldm
    assert all(torch.equal(v, before[k]) for k, v in cldm.state_dict().items())
    s = data["sp"]
    x, c_img = _t(s["x"]), _t(s["c_img"])
    assert inference.spatial_shard(x) is x and inference.gather(x) is x
    ref = cldm(x, _t(s["t"]), {"c_txt": _t(s["ctx"]), "c_img": c_img})
    assert torch.equal(sp_run(cldm, s), ref)
    model, rows = inference.shard_for_batch_parallel(cldm, data["batch"])
    assert model is cldm and rows is data["batch"]
    fn = lambda r: r  # noqa: E731
    assert inference.batch_parallel(fn) is fn
    assert inference.tile_parallel_model_fn(model_tiles) is model_tiles
    for name, (fn, x, kw) in tile_cases(data["tiles"]).items():
        out = inference.make_tile_sharded_fn(fn, **kw)(_t(x))
        if name != "ones":  # make_tiled_fn blends with Gaussian weights only
            n = len(tiling.sliding_windows(x.shape[1], x.shape[2], kw["size"], kw["stride"]))
            plain = tiling.make_tiled_fn(fn, tiles_per_batch=n, **kw)(_t(x))
            assert torch.equal(out, plain), name
