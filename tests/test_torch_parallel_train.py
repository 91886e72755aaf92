"""Tensor and spatial parallelism under autograd, and the data x tensor
stage-2 step, on four CPU processes over gloo, against ``jax.grad`` and
the JAX package's ``stage2.make_train_step``.

One launch of four processes (``tests/test_torch_parallel.py``'s
``launch``/``join``, under its timeout, through the DIFFBIR_* launch
contract) computes every case while the module's JAX references are
jitted. The processes form ``make_mesh(2, 2)``: the spatial- and
tensor-parallel cases run on each tensor group (ranks 0-1 and 2-3, two
processes each, the same answers), the step on the whole grid. fp32, with
JAX's matmuls pinned to fp32 (``tests/conftest.py``); the weights come
from JAX trees through ``flax_to_state_dict``.

1. The fault, first: the spatial-parallel ControlLDM's gradient with
   respect to x, ``c_img`` and ``c_txt`` with frozen weights, against
   ``jax.grad`` of JAX's one-device call. Before the collectives had a
   backward, the halo rows, the GroupNorm sums and the gathered k/v
   carried no gradient between the bands.
2. Tensor parallelism: the gradients of the ControlLDM's inputs and of
   its UNet's and ControlNet's weights (gradient checkpointing on; the
   one-head first level replicated, the second sharded), and of its CLIP
   tower's weights, the sharded ones gathered whole, against ``jax.grad``;
   a second ``tp_shard_`` changes nothing.
3. Spatial parallelism with the ControlNet trained and checkpointing on
   (the backward's recompute inside ``with fn:``): the ControlNet's
   gradients, summed over the bands, against ``jax.grad``.
4. The grid: two stage-2 steps with fsdp on, the ControlNet tensor-sharded
   and data-sharded on top, one row a data group with the draws of
   ``tests/test_torch_train.py::jax_draws`` split by data index; the loss,
   the grad norm, the gathered masters and first moments against JAX's
   ``make_train_step`` on the global batch. The whole state round-trips
   through ``state_dict``.
5. Planted faults, each failing its limit: *f*'s backward made an
   identity; the GroupNorm sums' backward without its all-reduce; the halo
   gradients dropped; the tensor ranks seeded apart (each process seeding
   its draws by its process index, not its data index: two steps against
   one process on the concatenated batch and draws).
6. ``make_mesh``'s error text, JAX's, where n_data x n_tensor is not the
   process count.
7. ``make_mesh(4, 1)``'s step bit-equal to today's data-parallel step.

Limits, measured on the CPU (each error x max|ref| of its tensor, a
parameter's floored at GRAD_FLOOR x the largest, as
``tests/test_torch_parallel.py`` explains; GRAD_TOL is its 5e-5): the
gradients against ``jax.grad`` 1.4e-6-3.6e-6 (SP), 8.9e-7-3.6e-6 (TP); the
parent commit's SP input gradients 0.60 (x) and 0.62 (c_img). The planted
faults: *f* 0.56-1.26, the GroupNorm sums 7.5e-2-0.96, the halos
0.36-0.81, each at least FAULT_MARGIN x the limit. The grid against JAX
(``tests/test_torch_train.py``'s limits for one process): the loss
3.1e-7-5.4e-7 and the grad norm 1.6e-7-2.8e-7 relative (LOSS_TOL_JAX), the
first moment 1.4e-5 (GRAD_TOL_JAX), the masters 8.5e-6 apart (within
UPDATES x lr, ``tests/test_torch_parallel.py``'s rule); seeded by data
index, the first moment 5.1e-6 from one process's, seeded apart 1.8-2.1.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diffbir_tpu import schedule as jax_schedule
from diffbir_tpu.models import cldm as jax_cldm
from diffbir_tpu.models.unet import UNetModel as JaxUNet
from diffbir_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffbir_tpu.train import stage2 as jax_stage2
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.parallel import collectives, distributed, inference, tp
from diffbir_tpu_torch.parallel.mesh import DataParallel, make_mesh
from diffbir_tpu_torch.schedule import Schedule
from diffbir_tpu_torch.train import stage2
from diffbir_tpu_torch.weights.convert import flax_to_state_dict
from tests.test_torch_models import CLIP_KW, VAE_KW, fill_params
from tests.test_torch_models import UNET_KW as TRAIN_UNET_KW
from tests.test_torch_parallel import GRAD_FLOOR, GRAD_TOL, UPDATES, free_port, join, launch
from tests.test_torch_parallel import start_group
from tests.test_torch_train import LR, NOISE_AUG, jax_draws, port_tiny

NPROC = 4
N_DATA, N_TENSOR = 2, 2
HW = 16  # the latent of the denoiser calls: bands of 8 rows at two processes
SEED = 231
# the grid against JAX: tests/test_torch_train.py's limits for one process
LOSS_TOL_JAX, GRAD_TOL_JAX = 1e-4, 1e-4
# a planted fault must read at least this many times its limit
FAULT_MARGIN = 10


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2).contiguous()


def _err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(np.asarray(ref)).double()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float((got - ref).abs().max() / ref.abs().max())


def grad_error(ref: dict, got: dict) -> float:
    """The largest error of a gradient tensor over its own max|ref| (at
    least GRAD_FLOOR x the largest gradient anywhere)."""
    floor = GRAD_FLOOR * max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    return max(float((torch.as_tensor(got[k]).double()
                      - torch.as_tensor(np.asarray(ref[k])).double()).abs().max())
               / max(float(np.abs(np.asarray(ref[k])).max()), floor) for k in ref)


# --------------------------------------------------------------------------- #
# the data, shared by the processes through one file
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``tests/test_torch_train.py``'s ControlLDM (1 head at its first
    level: replicated under two tensor processes; 2 at its second), its
    JAX tree, and the inputs of every case."""
    rng = np.random.default_rng(18)
    tree = fill_params(jax_tiny_model().eval_shapes((8, 8)), seed=0)
    d = {"tree": tree}
    ramp = np.linspace(1.0, -1.0, HW, dtype=np.float32)[None, :, None, None]
    d["call"] = dict(x=rng.standard_normal((1, HW, HW, 4)).astype(np.float32),
                     c_img=rng.standard_normal((1, HW, HW, 4)).astype(np.float32) + ramp,
                     ctx=rng.standard_normal((1, 77, 64)).astype(np.float32),
                     t=np.full((1,), 500.0, np.float32),
                     cot=rng.standard_normal((1, HW, HW, 4)).astype(np.float32),
                     tokens=np.concatenate([[[49406]], rng.integers(1, 49406, (1, 6)),
                                            [[49407]], np.zeros((1, 69), int)],
                                           axis=1).astype(np.int64),
                     clip_cot=rng.standard_normal((1, 77, 64)).astype(np.float32))
    rows = max(N_DATA, NPROC)
    batch = {"gt": (0.2 * rng.standard_normal((rows, 32, 32, 3))).astype(np.float32),
             "lq": rng.random((rows, 32, 32, 3)).astype(np.float32),
             "tokens": np.concatenate([np.array([[49406, 49407]] * rows),
                                       np.zeros((rows, 75), int)], 1).astype(np.int32)}
    grid_batch = {k: v[:N_DATA] for k, v in batch.items()}
    keys = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]
    d["grid"] = dict(batch=grid_batch, keys=keys,
                     draws=[jax_draws(grid_batch, k) for k in keys])
    d["dp"] = dict(batch=batch)  # test 7: one row a process
    path = str(tmp_path_factory.mktemp("parallel_train") / "data.pt")
    torch.save({k: v if k == "tree" else {n: a for n, a in v.items() if n != "keys"}
                for k, v in d.items()}, path)
    d["path"] = path
    return d


def jax_tiny_model():
    """The JAX ControlLDM of ``tests/test_torch_train.py``'s ``jax_tiny``."""
    from diffbir_tpu.models.clip import CLIPTextEncoder as JaxCLIP
    from diffbir_tpu.models.unet import ControlNet as JaxControlNet
    from diffbir_tpu.models.vae import AutoencoderKL as JaxVAE

    return jax_cldm.ControlLDM(unet=JaxUNet(**TRAIN_UNET_KW), vae=JaxVAE(**VAE_KW),
                               clip=JaxCLIP(**CLIP_KW), controlnet=JaxControlNet(**TRAIN_UNET_KW))


# --------------------------------------------------------------------------- #
# the processes' runs
# --------------------------------------------------------------------------- #
def model(tree, checkpointing: bool = False) -> ControlLDM:
    """``tests/test_torch_train.py``'s ControlLDM on ``tree``, frozen."""
    m = port_tiny(tree, use_checkpoint=checkpointing)
    return m.requires_grad_(False)


def summed(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of a replicated input's or weight's partial
    gradient."""
    t = t.clone()
    torch.distributed.all_reduce(t, group=group)
    return t


def whole_grads(module, group) -> dict:
    """Every trained parameter's gradient, tensor slices gathered whole."""
    out = {}
    for name, p in module.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        out[name] = tp.tp_whole(g, p.tp_dim, p.tp_splits, group) if hasattr(p, "tp_dim") else g
    return out


def sp_grads(d, group, train_controlnet: bool) -> dict:
    """The spatial-parallel ControlLDM on this process's band: the whole
    gradients of x, c_img and c_txt of sum(out * cot), and with
    ``train_controlnet`` (checkpointing on, forward and backward inside
    ``with fn:``) the ControlNet's, summed over the bands."""
    c = d["call"]
    cldm = model(d["tree"], checkpointing=train_controlnet)
    cldm.controlnet.requires_grad_(train_controlnet)
    x = inference.spatial_shard(_t(c["x"]), group).clone().requires_grad_()
    c_img = inference.spatial_shard(_t(c["c_img"]), group).clone().requires_grad_()
    ctx = _t(c["ctx"]).clone().requires_grad_()
    cot = inference.spatial_shard(_t(c["cot"]), group)
    fn = inference.spatial_parallel(cldm, group)

    def backward():
        (fn(x, _t(c["t"]), {"c_txt": ctx, "c_img": c_img}) * cot).sum().backward()

    if train_controlnet:
        with fn:
            backward()
    else:
        backward()
    out = {"x": inference.gather(x.grad, group), "c_img": inference.gather(c_img.grad, group),
           "ctx": summed(ctx.grad, group)}
    if train_controlnet:
        out["controlnet"] = {n: summed(p.grad, group)
                             for n, p in cldm.controlnet.named_parameters()}
    return out


def tp_grads(d, group) -> dict:
    """The tensor-parallel ControlLDM (checkpointing on, the UNet and the
    ControlNet trained): the gradients of x, c_img, c_txt and their
    weights; then its CLIP tower's weights'."""
    c = d["call"]
    cldm = tp.tp_shard_(model(d["tree"], checkpointing=True), group)
    cldm.unet.requires_grad_(True)
    cldm.controlnet.requires_grad_(True)
    x, c_img, ctx = (_t(c[k]).clone().requires_grad_() for k in ("x", "c_img", "ctx"))
    (cldm(x, _t(c["t"]), {"c_txt": ctx, "c_img": c_img}) * _t(c["cot"])).sum().backward()
    out = {"x": x.grad, "c_img": c_img.grad, "ctx": ctx.grad,
           "controlnet": whole_grads(cldm.controlnet, group),
           "unet": whole_grads(cldm.unet, group)}
    cldm.clip.requires_grad_(True)
    (cldm.encode_text(_t(c["tokens"])) * _t(c["clip_cot"])).sum().backward()
    out["clip"] = whole_grads(cldm.clip, group)
    shapes = {k: v.shape for k, v in cldm.state_dict().items()}
    tp.tp_shard_(cldm, group)  # a second call: every unit is sharded already
    out["sharded_twice"] = {k: v.shape for k, v in cldm.state_dict().items()} == shapes
    return out


def seeded_draws(gen: torch.Generator, bs: int, latent: tuple) -> dict:
    """One step's draws from ``gen``, in ``make_loss_fn``'s order."""
    return {"posterior": torch.randn((bs, *latent), generator=gen),
            "aug": torch.randn((bs, *latent), generator=gen),
            "t": torch.randint(0, 1000, (bs,), generator=gen),
            "noise": torch.randn((bs, *latent), generator=gen)}


def grid_latent(d) -> tuple:
    return d["grid"]["draws"][0]["noise"].shape[1:]


def train_steps(d, parallel, rows: slice, seeded_by=None) -> dict:
    """Two stage-2 steps of ``tests/test_torch_train.py``'s ControlLDM on
    ``rows`` of the batch: JAX's draws of those rows, or (``seeded_by``:
    the seed) two steps' draws from one generator."""
    g = d["grid"]
    tc = port_tiny(d["tree"])
    opt = stage2.init_train_state(tc, LR, parallel=parallel)
    step = stage2.make_train_step(tc, Schedule.v21(), opt, noise_aug_timestep=NOISE_AUG)
    batch = {k: torch.tensor(v[rows], dtype=torch.long if k == "tokens" else torch.float32)
             for k, v in g["batch"].items()}
    gen = None if seeded_by is None else torch.Generator().manual_seed(seeded_by)
    losses, norms = [], []
    for i in range(2):
        if gen is None:
            draws = {k: torch.tensor(v[rows]) for k, v in g["draws"][i].items()}
        else:
            draws = seeded_draws(gen, rows.stop - rows.start, grid_latent(d))
        m = step(batch, draws=draws)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    state = opt.state_dict()
    names = [n for n, _ in tc.controlnet.named_parameters()]
    out = {"losses": losses, "norms": norms, "masters": dict(zip(names, state["masters"])),
           "exp_avg": {names[i]: s["exp_avg"] for i, s in state["optimizer"]["state"].items()},
           "placed": (sum(d is not None for d in opt.dims), sum(t is not None for t in opt.tp)),
           "updates": opt.updates}
    before = [m.clone() for m in opt.masters]
    opt.load_state_dict(state)
    out["round_trip"] = all(torch.equal(a, b) for a, b in zip(before, opt.masters))
    return out


def dp_steps(d, parallel, rank: int) -> dict:
    """Test 7: one step on this rank's row."""
    cldm = port_tiny(d["tree"])
    opt = stage2.init_train_state(cldm, LR, parallel=parallel)
    step = stage2.make_train_step(cldm, Schedule.v21(), opt, noise_aug_timestep=NOISE_AUG)
    b = {k: torch.tensor(v[rank:rank + 1]) for k, v in d["dp"]["batch"].items()}
    b["tokens"] = b["tokens"].long()
    m = step(b, draws=seeded_draws(torch.Generator().manual_seed(SEED + rank), 1,
                                   grid_latent(d)))
    return {"loss": m["loss"], "norm": m["grad_norm"], "masters": opt.full_masters()}


class planted:
    """``owner.name`` replaced by ``value`` while in this context."""

    def __init__(self, owner, name: str, value):
        self.owner, self.name, self.value = owner, name, value

    def __enter__(self):
        self.real = self.owner.__dict__[self.name]
        setattr(self.owner, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def _identity_backward(ctx, g):
    return g, None


def _dropped_halo_backward(ctx, g):
    return g.new_zeros(ctx.shape), None, None


def _seed_by_process(seed: int, grid=None) -> int:
    return seed + distributed.process_index() * 1_000_003


def raises(fn, error=ValueError) -> str:
    try:
        fn()
    except error as e:
        return str(e)
    return ""


def sp_outside_the_context(d, group) -> str:
    """A differentiated spatial-parallel call through checkpointed blocks
    outside ``with fn:``: its error."""
    c = d["call"]
    cldm = model(d["tree"], checkpointing=True)
    fn = inference.spatial_parallel(cldm, group)
    x = inference.spatial_shard(_t(c["x"]), group).clone().requires_grad_()
    c_img = inference.spatial_shard(_t(c["c_img"]), group)
    return raises(lambda: fn(x, _t(c["t"]), {"c_txt": _t(c["ctx"]), "c_img": c_img}),
                  RuntimeError)


def worker(rank, port, path, out_dir):
    start_group(rank, port, NPROC)
    try:
        d = torch.load(path, weights_only=False)
        grid = make_mesh(N_DATA, N_TENSOR)
        pair = grid.tensor_group
        out = {"index": (grid.data_index, grid.tensor_index)}
        out["sp_frozen"] = sp_grads(d, pair, train_controlnet=False)
        out["sp"] = sp_grads(d, pair, train_controlnet=True)
        out["sp_outside"] = sp_outside_the_context(d, pair)
        with planted(collectives.AllReduceSum, "backward", staticmethod(_identity_backward)):
            out["fault_gn"] = sp_grads(d, pair, train_controlnet=True)
        with planted(collectives.HaloRows, "backward", staticmethod(_dropped_halo_backward)):
            out["fault_halo"] = sp_grads(d, pair, train_controlnet=True)
        out["tp"] = tp_grads(d, pair)
        with planted(collectives.CopyToTensorParallel, "backward",
                     staticmethod(_identity_backward)):
            out["fault_f"] = tp_grads(d, pair)
        rows = slice(grid.data_index, grid.data_index + 1)
        parallel = DataParallel("mean", fsdp=True, grid=grid)
        out["grid"] = train_steps(d, parallel, rows)
        out["seeded"] = train_steps(d, DataParallel("mean", fsdp=True, grid=grid), rows,
                                    seeded_by=distributed.process_seed(SEED, grid))
        with planted(distributed, "process_seed", _seed_by_process):
            out["fault_seed"] = train_steps(d, DataParallel("mean", fsdp=True, grid=grid), rows,
                                            seeded_by=distributed.process_seed(SEED, grid))
        grid1 = make_mesh(NPROC, 1)
        out["dp_grid"] = dp_steps(d, DataParallel("mean", fsdp=True, grid=grid1), rank)
        out["dp_plain"] = dp_steps(d, DataParallel("mean", fsdp=True), rank)
        out["mesh_errors"] = [raises(lambda: make_mesh(3, 2)), raises(lambda: make_mesh(None, 3))]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown_distributed()


@pytest.fixture(scope="module")
def launched(data, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    return launch(worker, free_port(), data["path"], out_dir, nprocs=NPROC), out_dir


# --------------------------------------------------------------------------- #
# the JAX references (jitted once), computed while the processes run
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_refs(data, launched):
    jc = jax_tiny_model()
    tree = data["tree"]
    c = data["call"]

    def cldm_loss(cn, unet, x, c_img, ctx):
        p = {**tree, "controlnet": cn, "unet": unet}
        return jnp.sum(jc(p, x, c["t"], {"c_txt": ctx, "c_img": c_img}) * c["cot"])

    def clip_loss(cp):
        return jnp.sum(jc.encode_text({**tree, "clip": cp}, c["tokens"]) * c["clip_cot"])

    grads = jax.jit(lambda: (jax.grad(cldm_loss, argnums=range(5))(
        tree["controlnet"], tree["unet"], c["x"], c["c_img"], c["ctx"]),
        jax.grad(clip_loss)(tree["clip"])))
    (g_cn, g_unet, g_x, g_c, g_ctx), g_clip = jax.device_get(grads())
    refs = {"x": g_x, "c_img": g_c, "ctx": g_ctx, "controlnet": flax_to_state_dict(g_cn),
            "unet": flax_to_state_dict(g_unet), "clip": flax_to_state_dict(g_clip)}
    g = data["grid"]
    js = jax_schedule.Schedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012,
                                      zero_snr=True, parameterization="v")
    jopt = jax_stage2.make_optimizer(LR)
    state = jax_stage2.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), jopt)
    step = jax.jit(jax_stage2.make_train_step(jc, js, jopt, noise_aug_timestep=NOISE_AUG))
    metrics = []
    for key in g["keys"]:
        state, m = step(state, g["batch"], key)
        metrics.append(m)
    refs["grid"] = {
        "losses": [float(m["loss"]) for m in metrics],
        "norms": [float(m["grad_norm"]) for m in metrics],
        "masters": flax_to_state_dict(jax.device_get(state.params["controlnet"])),
        "exp_avg": flax_to_state_dict(jax.device_get(
            optax.tree_utils.tree_get(state.opt_state, "mu")))}
    return refs


@pytest.fixture(scope="module")
def ranks(launched, jax_refs):
    ctx, out_dir = launched
    join(ctx, "parallel_train worker")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(NPROC)]


@pytest.fixture(scope="module")
def seeded_reference(data):
    """One process, no process group, on the concatenated batch and the
    draws of both data indices (``process_seed(SEED)`` of each)."""
    gens = [torch.Generator().manual_seed(SEED + i * 1_000_003) for i in range(N_DATA)]
    draws = []
    for _ in range(2):
        parts = [seeded_draws(gen, 1, grid_latent(data)) for gen in gens]
        draws.append({k: torch.cat([p[k] for p in parts]) for k in parts[0]})
    g = dict(data["grid"], draws=[{k: v.numpy() for k, v in dr.items()} for dr in draws])
    return train_steps(dict(data, grid=g), None, slice(0, N_DATA))


# --------------------------------------------------------------------------- #
# 1. the fault: SP gradients with respect to the inputs
# --------------------------------------------------------------------------- #
INPUTS = ("x", "c_img", "ctx")


def test_sp_input_gradients_match_jax(ranks, jax_refs):
    """The spatial-parallel call with frozen weights, differentiated with
    respect to x, c_img and c_txt (guidance's and the stage-2 step's
    pattern), equals jax.grad of the one-device call."""
    for r in ranks:
        for k in INPUTS:
            assert _err(r["sp_frozen"][k], jax_refs[k]) <= GRAD_TOL, k


# --------------------------------------------------------------------------- #
# 2. tensor-parallel gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("part", ["unet", "controlnet", "clip"])
def test_tp_weight_gradients_match_jax(ranks, jax_refs, part):
    """The UNet's and the ControlNet's weights (the level with one head
    replicated, the other sharded), and the CLIP tower's, gathered whole."""
    for r in ranks:
        got = r["tp"][part]
        assert got.keys() == jax_refs[part].keys()
        assert grad_error(jax_refs[part], got) <= GRAD_TOL


def test_tp_shard_twice_changes_nothing(ranks):
    assert all(r["tp"]["sharded_twice"] for r in ranks)


def test_tp_input_gradients_match_jax(ranks, jax_refs):
    for r in ranks:
        for k in INPUTS:
            assert _err(r["tp"][k], jax_refs[k]) <= GRAD_TOL, k


# --------------------------------------------------------------------------- #
# 3. spatial-parallel ControlNet gradients
# --------------------------------------------------------------------------- #
def test_sp_controlnet_gradients_match_jax(ranks, jax_refs):
    for r in ranks:
        got = r["sp"]
        assert grad_error(jax_refs["controlnet"], got["controlnet"]) <= GRAD_TOL
        for k in INPUTS:
            assert _err(got[k], jax_refs[k]) <= GRAD_TOL, k


def test_sp_without_a_process_group_is_the_plain_denoiser(data):
    """Without a process group ``fn`` is the plain denoiser and its context
    a no-op."""
    cldm = model(data["tree"], checkpointing=True)
    fn = inference.spatial_parallel(cldm)
    c = data["call"]
    x = _t(c["x"]).requires_grad_()
    cond = {"c_txt": _t(c["ctx"]), "c_img": _t(c["c_img"])}
    with fn:
        out = fn(x, _t(c["t"]), cond)
    assert torch.equal(out, cldm(x, _t(c["t"]), cond))


def test_sp_under_checkpointing_outside_the_context_raises(ranks):
    """Outside ``with fn:``, a differentiated call through checkpointed
    blocks raises: its recompute in the backward would run the unbanded
    layers on a band."""
    msg = ranks[0]["sp_outside"]
    assert "with fn:" in msg and "checkpointing" in msg


# --------------------------------------------------------------------------- #
# 4. the grid
# --------------------------------------------------------------------------- #
def test_grid_is_laid_out_as_jax_reshapes_the_devices(ranks):
    """global rank = data index x n_tensor + tensor index."""
    assert [r["index"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_grid_steps_match_jax(ranks, jax_refs):
    ref = jax_refs["grid"]
    for r in ranks:
        got = r["grid"]
        assert got["updates"] == UPDATES
        data_sharded, tensor_sliced = got["placed"]
        assert data_sharded > 0 and tensor_sliced > 0
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_TOL_JAX)
        np.testing.assert_allclose(got["norms"], ref["norms"], rtol=LOSS_TOL_JAX)
        assert got["masters"].keys() == ref["masters"].keys()
        assert grad_error(ref["exp_avg"], got["exp_avg"]) <= GRAD_TOL_JAX
        for k, v in ref["masters"].items():
            np.testing.assert_allclose(got["masters"][k].numpy(), v.numpy(), atol=UPDATES * LR,
                                       rtol=0, err_msg=k)
        assert got["round_trip"]
    for r in ranks[1:]:  # every process holds the same whole state
        for k, v in ranks[0]["grid"]["masters"].items():
            assert torch.equal(r["grid"]["masters"][k], v), k


def test_grid_seeded_by_data_index_matches_one_process(ranks, seeded_reference):
    """The processes of a tensor group draw from one seed (the data
    index's): two steps equal one process's on both data indices' rows."""
    ref = seeded_reference
    for r in ranks:
        got = r["seeded"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_TOL_JAX)
        assert grad_error(ref["exp_avg"], got["exp_avg"]) <= GRAD_TOL


# --------------------------------------------------------------------------- #
# 5. planted faults
# --------------------------------------------------------------------------- #
def test_f_with_an_identity_backward_fails_the_limit(ranks, jax_refs):
    err = _err(ranks[0]["fault_f"]["x"], jax_refs["x"])
    assert err > FAULT_MARGIN * GRAD_TOL, err


@pytest.mark.parametrize("fault", ["fault_gn", "fault_halo"])
def test_sp_planted_faults_fail_the_limit(ranks, jax_refs, fault):
    got = ranks[0][fault]
    err = max(grad_error(jax_refs["controlnet"], got["controlnet"]),
              _err(got["x"], jax_refs["x"]))
    assert err > FAULT_MARGIN * GRAD_TOL, err


def test_tensor_ranks_seeded_apart_fail_the_limit(ranks, seeded_reference):
    err = grad_error(seeded_reference["exp_avg"], ranks[0]["fault_seed"]["exp_avg"])
    assert err > FAULT_MARGIN * GRAD_TOL, err


# --------------------------------------------------------------------------- #
# 6-7. make_mesh
# --------------------------------------------------------------------------- #
def _head(msg: str) -> str:
    """An error's sentence before its parenthesis (the port's names the
    processes where JAX's names the platforms)."""
    return msg.split(" (")[0]


def test_make_mesh_error_text_is_jax_s(ranks):
    devices = jax.devices()[:NPROC]
    for got, (n_data, n_tensor) in zip(ranks[0]["mesh_errors"], ((3, 2), (None, 3))):
        with pytest.raises(ValueError) as e:
            jax_make_mesh(n_data, n_tensor, devices=devices)
        assert got and _head(got) == _head(str(e.value))
    with pytest.raises(ValueError) as e:
        jax_make_mesh(2, 2, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as mine:
        make_mesh(2, 2)  # no process group: one process
    assert _head(str(mine.value)) == _head(str(e.value))


def test_one_tensor_index_is_the_data_parallel_step(ranks):
    """make_mesh(4, 1): the data group is the whole process group, and an
    fsdp step is bit-equal to DataParallel's without a grid."""
    for r in ranks:
        a, b = r["dp_grid"], r["dp_plain"]
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["norm"], b["norm"])
        assert all(torch.equal(x, y) for x, y in zip(a["masters"], b["masters"]))
