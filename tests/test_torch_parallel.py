"""``diffbir_tpu_torch/parallel/`` on two CPU processes over gloo.

Each multi-process case starts two processes with
``torch.multiprocessing.spawn`` from this file, under its own timeout
(SPAWN_TIMEOUT: a hang fails the test), through the port's own launch
contract (DIFFBIR_COORDINATOR / NUM_PROCESSES / PROCESS_ID). Each process
takes its half of a global batch; the results are held against one process
on the concatenated batch, as ``tests/test_distributed.py`` and
``tests/test_parallel.py`` do for JAX:

- the stage-1 step (a sum over the global batch): the reduced gradients
  within GRAD_TOL x each tensor's max|ref| of one process's, the losses
  within LOSS_TOL; the same processes reducing by the mean (gradients off
  by 2x) must fail that limit;
- the stage-2 step (a batch mean): the same, with the sum failing;
- ``train.fsdp``: the masters after two updates (also with accum_steps 2)
  equal to the unsharded processes' within FSDP_TOL, with leaves really
  sharded, and within lr an update of one process's (AdamW moves a
  parameter by ~lr whatever its gradient, so where a gradient element is
  rounding noise its step can differ by up to that);
- ``fsdp_dim`` against JAX's ``fsdp_spec`` on the same shapes;
- ``process_seed`` and ``is_main_process`` on each rank;
- ``python -m diffbir_tpu_torch.train_stage1``'s ``main`` in two processes
  (plain and fsdp) against one process on the concatenated batches that the
  two ranks draw, and rank 0's checkpoint resuming in one process bit for
  bit.
"""

import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from diffbir_tpu_torch import dataset  # noqa: F401  (the registry names)
from diffbir_tpu_torch import train_stage1
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.models.layers import random_init_
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.parallel import distributed
from diffbir_tpu_torch.parallel.fsdp import fsdp_dim
from diffbir_tpu_torch.parallel.mesh import DataParallel
from diffbir_tpu_torch.schedule import Schedule
from diffbir_tpu_torch.train import stage1, stage2
from diffbir_tpu_torch.utils.image_io import write_png

WORLD, LOCAL = 2, 2          # processes, images per process
SPAWN_TIMEOUT = 240          # seconds for one spawn of WORLD processes
SWIN = dict(embed_dim=16, depths=[1], num_heads=[2], window_size=4)
LR1, LR2, NOISE_AUG = 1e-3, 1e-4, 200
# fp32 on the CPU: the two processes sum their halves' gradients (or
# average them) where one process sums the whole batch in one pass; the
# order of the sums differs. Measured: stage 1 1.1e-6, stage 2 1.0e-5 (on
# the floor below); losses 1e-7 relative.
GRAD_TOL, LOSS_TOL = 5e-5, 1e-5
# a gradient tensor is measured against its own max|ref|, but no less than
# GRAD_FLOOR x the largest gradient anywhere: some true gradients are 0 (a
# bias that the next GroupNorm removes, at one channel a group in the tiny
# UNet; softmax's key bias) and hold rounding noise (~1e-9) only
GRAD_FLOOR = 1e-2
# sharded and unsharded AdamW over the same reduced gradients: the same
# elementwise arithmetic on slices (measured bit-equal)
FSDP_TOL = 1e-6
# parameters against one process after UPDATES AdamW updates: each moves a
# parameter by up to ~lr whatever its gradient's size, so where a gradient
# is rounding noise (see GRAD_FLOOR) the two can differ by up to that
UPDATES = 2


# --------------------------------------------------------------------------- #
# launching
# --------------------------------------------------------------------------- #
def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(fn, *args, nprocs=WORLD):
    """``fn(rank, *args)`` started in ``nprocs`` fresh processes."""
    return mp.spawn(fn, args=args, nprocs=nprocs, join=False)


def join(ctx, name: str, timeout=SPAWN_TIMEOUT):
    """Wait for ``launch``'s processes; fails the test if one raises or they
    are not done within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{name}: {len(ctx.processes)} processes not done in {timeout} s")


def spawn(fn, *args, timeout=SPAWN_TIMEOUT, nprocs=WORLD):
    """``fn(rank, *args)`` in ``nprocs`` fresh processes; fails the test if
    one raises or they are not done within ``timeout`` seconds."""
    join(launch(fn, *args, nprocs=nprocs), fn.__name__, timeout)


def start_group(rank: int, port: int, world: int = WORLD) -> None:
    torch.set_num_threads(1)
    os.environ.update(DIFFBIR_COORDINATOR=f"127.0.0.1:{port}",
                      DIFFBIR_NUM_PROCESSES=str(world), DIFFBIR_PROCESS_ID=str(rank))
    assert distributed.maybe_initialize_distributed("cpu")


def local(tree, rank):
    """This rank's rows of a global batch (or draws)."""
    return {k: v[rank * LOCAL:(rank + 1) * LOCAL] for k, v in tree.items()}


# --------------------------------------------------------------------------- #
# the steps: tiny models, seeded data
# --------------------------------------------------------------------------- #
def tiny_swinir():
    return random_init_(SwinIR(**SWIN), torch.Generator().manual_seed(0)).train()


def tiny_cldm():
    return random_init_(ControlLDM.tiny(), torch.Generator().manual_seed(3))


def stage1_batches(n=2):
    rng = np.random.default_rng(21)
    return [{k: torch.from_numpy(rng.random((WORLD * LOCAL, 32, 32, 3)).astype(np.float32))
             for k in ("gt", "lq")} for _ in range(n)]


def stage2_inputs(n):
    rng = np.random.default_rng(22)
    bs = WORLD * LOCAL
    batches, draws = [], []
    for _ in range(n):
        batches.append({
            "gt": torch.from_numpy((0.2 * rng.standard_normal((bs, 32, 32, 3)))
                                   .astype(np.float32)),
            "lq": torch.from_numpy(rng.random((bs, 32, 32, 3)).astype(np.float32)),
            "tokens": torch.tensor([[49406, 49407] + [0] * 75] * bs)})
        draws.append({k: torch.from_numpy(rng.standard_normal((bs, 4, 4, 4)).astype(np.float32))
                      for k in ("posterior", "aug", "noise")})
        draws[-1]["t"] = torch.from_numpy(rng.integers(0, 1000, bs))
    return batches, draws


def capture_gradients(opt, into: list):
    """Record (whole, on the host) the first micro-batch's reduced
    gradients that ``opt`` sees."""
    reduce = opt.gradients

    def recorded():
        grads = reduce()
        if not into:
            into.extend(opt._gather(g, d).clone() for g, d in zip(grads, opt.dims))
        return grads

    opt.gradients = recorded


def run_stage1(rank, reduce):
    """Two stage-1 steps; ``rank`` None: one process on the whole batch."""
    model = tiny_swinir()
    parallel = None if rank is None else DataParallel(reduce)
    opt = stage1.init_train_state(model, LR1, parallel=parallel)
    grads = []
    capture_gradients(opt, grads)
    step = stage1.make_train_step(model, opt)
    losses = [float(step(b if rank is None else local(b, rank))["loss"])
              for b in stage1_batches()]
    names = [n for n, _ in model.named_parameters()]
    return {"losses": losses, "grads": dict(zip(names, grads)),
            "masters": dict(zip(names, opt.full_masters()))}


def run_stage2(rank, reduce="mean", fsdp=False, accum=1):
    """Two AdamW updates of the stage-2 step (2 x accum micro-batches)."""
    cldm = tiny_cldm()
    parallel = None if rank is None else DataParallel(reduce, fsdp=fsdp)
    opt = stage2.init_train_state(cldm, LR2, accum, parallel)
    grads = []
    capture_gradients(opt, grads)
    step = stage2.make_train_step(cldm, Schedule.v21(), opt, noise_aug_timestep=NOISE_AUG)
    losses, norms = [], []
    for b, d in zip(*stage2_inputs(2 * accum)):
        if rank is not None:
            b, d = local(b, rank), local(d, rank)
        m = step(b, draws=d)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    names = [n for n, _ in cldm.controlnet.named_parameters()]
    return {"losses": losses, "norms": norms, "grads": dict(zip(names, grads)),
            "masters": dict(zip(names, opt.full_masters())), "updates": opt.updates,
            "sharded": sum(d is not None for d in opt.dims)}


def steps_worker(rank, port, out_dir):
    start_group(rank, port)
    try:
        out = {"seed": distributed.process_seed(231), "main": distributed.is_main_process(),
               "s1_sum": run_stage1(rank, "sum"), "s1_mean": run_stage1(rank, "mean"),
               "s2_mean": run_stage2(rank), "s2_sum": run_stage2(rank, "sum"),
               "s2_fsdp": run_stage2(rank, fsdp=True),
               "s2_mean_accum": run_stage2(rank, accum=2),
               "s2_fsdp_accum": run_stage2(rank, fsdp=True, accum=2)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown_distributed()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("steps"))
    spawn(steps_worker, free_port(), out_dir)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
            for r in range(WORLD)]


def grad_error(ref, got):
    """The largest error of a gradient tensor over its own max|ref| (at
    least GRAD_FLOOR x the largest gradient)."""
    floor = GRAD_FLOOR * max(float(v.abs().max()) for v in ref.values())
    return max(float((ref[k] - got[k]).abs().max()) / max(float(ref[k].abs().max()), floor)
               for k in ref)


def close_params(ref, got, atol):
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=atol, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def one_process_stage1():
    return run_stage1(None, None)


@pytest.fixture(scope="module")
def one_process_stage2():
    return {accum: run_stage2(None, accum=accum) for accum in (1, 2)}


def test_stage1_step_sums_over_processes(steps, one_process_stage1):
    ref = one_process_stage1
    for r in steps:
        got = r["s1_sum"]
        assert grad_error(ref["grads"], got["grads"]) <= GRAD_TOL
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_TOL)
        close_params(ref["masters"], got["masters"], atol=UPDATES * LR1)
    # both ranks hold the same state
    for k, v in steps[0]["s1_sum"]["masters"].items():
        assert torch.equal(v, steps[1]["s1_sum"]["masters"][k]), k


def test_stage1_mean_reduction_fails_the_limit(steps, one_process_stage1):
    """Averaging (DistributedDataParallel's default) halves the summed
    loss's gradients: the check has the power to see it."""
    err = grad_error(one_process_stage1["grads"], steps[0]["s1_mean"]["grads"])
    assert err > 100 * GRAD_TOL, err
    assert err == pytest.approx(0.5, rel=1e-3)


def test_stage2_step_averages_over_processes(steps, one_process_stage2):
    ref = one_process_stage2[1]
    for r in steps:
        got = r["s2_mean"]
        assert grad_error(ref["grads"], got["grads"]) <= GRAD_TOL
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_TOL)
        np.testing.assert_allclose(got["norms"], ref["norms"], rtol=LOSS_TOL)
        close_params(ref["masters"], got["masters"], atol=UPDATES * LR2)
    err = grad_error(ref["grads"], steps[0]["s2_sum"]["grads"])
    assert err > 100 * GRAD_TOL and err == pytest.approx(1.0, rel=1e-3), err


@pytest.mark.parametrize("accum", [1, 2])
def test_fsdp_equals_unsharded(steps, one_process_stage2, accum):
    suffix = "" if accum == 1 else "_accum"
    for r in steps:
        plain, sharded = r["s2_mean" + suffix], r["s2_fsdp" + suffix]
        assert sharded["sharded"] > 0 and plain["sharded"] == 0
        assert sharded["updates"] == plain["updates"] == 2
        np.testing.assert_allclose(sharded["losses"], plain["losses"], rtol=0, atol=0)
        np.testing.assert_allclose(sharded["norms"], plain["norms"], rtol=LOSS_TOL)
        for k, v in plain["masters"].items():
            np.testing.assert_allclose(sharded["masters"][k].numpy(), v.numpy(), rtol=FSDP_TOL,
                                       atol=FSDP_TOL * float(v.abs().max()), err_msg=k)
        close_params(one_process_stage2[accum]["masters"], sharded["masters"],
                     atol=UPDATES * LR2)


def test_fsdp_dim_matches_jax_fsdp_spec():
    """The port's rule on the tiny ControlNet's and SwinIR's shapes and on
    edge cases (ties, nothing divisible, scalars, one process)."""
    import jax
    import jax.numpy as jnp

    from diffbir_tpu.parallel.fsdp import fsdp_spec

    shapes = {tuple(p.shape) for p in ControlLDM.tiny(device="meta").controlnet.parameters()}
    shapes |= {tuple(p.shape) for p in SwinIR(**SWIN, device="meta").parameters()}
    shapes |= {(), (7,), (6, 6), (3, 5, 7), (4, 3, 4), (9, 6, 3, 3), (1, 1)}
    for n in (1, 2, 3, 4, 8):
        for shape in sorted(shapes):
            spec = fsdp_spec((), jax.ShapeDtypeStruct(shape, jnp.float32), n)
            want = next((i for i, a in enumerate(spec) if a == "data"), None)
            assert fsdp_dim(shape, n) == want, (shape, n, spec)


def test_process_seed_and_main_process(steps):
    assert [r["seed"] for r in steps] == [231, 231 + 1_000_003]
    assert [r["main"] for r in steps] == [True, False]
    assert distributed.process_seed(231) == 231 and distributed.is_main_process()


# --------------------------------------------------------------------------- #
# train_stage1.main in two processes
# --------------------------------------------------------------------------- #
DATASET = """\
    target: codeformer_dataset
    params:
      file_list: {flist}
      file_backend_cfg:
        target: hard_disk_backend
      out_size: 32
      crop_type: center
      blur_kernel_size: 21
      kernel_list: ['iso', 'aniso']
      kernel_prob: [0.5, 0.5]
      blur_sigma: [0.1, 3]
      downsample_range: [1, 4]
      noise_range: [0, 15]
      jpeg_range: [30, 100]
      p_empty_prompt: 0.0
"""
CONFIG = """\
model:
  swinir:
    target: diffbir_tpu.models.swinir.SwinIR
    params:
      embed_dim: 16
      depths: [1]
      num_heads: [2]
      window_size: 4
      mlp_ratio: 2
      sf: 8
      upsampler: "nearest+conv"
      unshuffle: true
      unshuffle_scale: 8

dataset:
  train:
{ds}  val:
{ds}
train:
  learning_rate: 1e-3
  batch_size: {bs}
  train_steps: {steps}
  log_every: 1
  val_every: 2
  val_batches: 2
  ckpt_every: 1
  resume: {resume}
  exp_dir: {exp}
  seed: 231
  fsdp: {fsdp}
"""
MAIN_STEPS = 4


def write_config(root, exp, bs=WORLD * LOCAL, steps=MAIN_STEPS, resume="null", fsdp="false"):
    os.makedirs(exp, exist_ok=True)
    path = os.path.join(exp, "train.yaml")
    with open(path, "w") as f:
        f.write(CONFIG.format(ds=DATASET.format(flist=os.path.join(root, "list.txt")), bs=bs,
                              steps=steps, resume=resume, exp=exp, fsdp=fsdp))
    return path


def main_worker(rank, ports, root):
    torch.set_num_threads(1)
    for port, fsdp in zip(ports, ("false", "true")):
        os.environ.update(DIFFBIR_COORDINATOR=f"127.0.0.1:{port}",
                          DIFFBIR_NUM_PROCESSES=str(WORLD), DIFFBIR_PROCESS_ID=str(rank))
        exp = os.path.join(root, f"exp_{fsdp}")
        trainer = train_stage1.main(["--config", write_config(root, exp, fsdp=fsdp),
                                     "--device", "cpu"])
        torch.save({"losses": trainer.losses, "val": trainer.val_psnr,
                    "sharded": sum(d is not None for d in trainer.optimizer.dims),
                    "group_left": torch.distributed.is_initialized()},
                   os.path.join(exp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two_process_main(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("main"))
    rng = np.random.default_rng(1)
    lines = []
    for i in range(5):
        path = os.path.join(root, f"img{i}.png")
        write_png(path, rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
        lines.append(path)
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    spawn(main_worker, (free_port(), free_port()), root)
    return root


def test_two_process_main_equals_one_process(two_process_main):
    """One process on the concatenation of what the two ranks draw (each
    from process_seed(231)) trains to the same state, loss for loss; the
    validation (each rank on the same batches) reads the same PSNR."""
    root = two_process_main
    cfg = train_stage1.cfglib.load_yaml(write_config(root, os.path.join(root, "one"),
                                                     steps=0))
    one = train_stage1.Stage1Trainer(cfg, "cpu")
    its = []
    for r in range(WORLD):
        ds = train_stage1.cfglib.instantiate(cfg["dataset"]["train"])
        its.append(ds.as_iterator(LOCAL, seed=231 + r * 1_000_003))
    losses, val = [], None
    for s in range(MAIN_STEPS):
        parts = [train_stage1.to_unit_range(next(it)) for it in its]
        batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])) for k in ("gt", "lq")}
        losses.append(float(one.train_step(batch)["loss"]))
        if s == 1:
            vit = train_stage1.cfglib.instantiate(cfg["dataset"]["val"]).as_iterator(
                LOCAL, shuffle=False)
            val = float(np.mean([float(one.val_step(
                {k: torch.from_numpy(v) for k, v in train_stage1.to_unit_range(next(vit)).items()}
            )["psnr"]) for _ in range(2)]))
    names = [n for n, _ in one.model.named_parameters()]
    ref = dict(zip(names, one.optimizer.masters))
    for fsdp in ("false", "true"):
        exp = os.path.join(root, f"exp_{fsdp}")
        ranks = [torch.load(os.path.join(exp, f"rank{r}.pt"), weights_only=True)
                 for r in range(WORLD)]
        assert [r["group_left"] for r in ranks] == [False, False]
        assert (ranks[0]["sharded"] > 0) == (fsdp == "true")
        for r in ranks:
            np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_TOL)
            assert len(r["val"]) == 2 and r["val"][0] == pytest.approx(val, rel=LOSS_TOL)
        assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == ["2.pt", "3.pt", "4.pt"]
        saved = torch.load(os.path.join(exp, "checkpoints", "4.pt"), weights_only=True)
        close_params(ref, dict(zip(names, saved["masters"])), atol=MAIN_STEPS * LR1)


def test_rank0_checkpoint_resumes_in_one_process(two_process_main, tmp_path):
    """The sharded run's checkpoint (gathered, written by rank 0) restores
    bit for bit in one process and trains on."""
    exp = str(tmp_path / "exp")
    shutil.copytree(os.path.join(two_process_main, "exp_true"), exp)
    saved = torch.load(os.path.join(exp, "checkpoints", "4.pt"), weights_only=True)
    cfg = train_stage1.cfglib.load_yaml(
        write_config(two_process_main, exp, steps=MAIN_STEPS + 1, resume=MAIN_STEPS))
    trainer = train_stage1.Stage1Trainer(cfg, "cpu")
    assert trainer.step == MAIN_STEPS
    for m, p, s in zip(trainer.optimizer.masters, trainer.model.parameters(), saved["masters"]):
        assert torch.equal(m, s) and torch.equal(p, s)
    state = trainer.optimizer.optimizer.state_dict()["state"]
    for i, s in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state[i][key], s[key]), (i, key)
    trainer.run()
    assert trainer.step == MAIN_STEPS + 1 and np.isfinite(trainer.losses).all()
