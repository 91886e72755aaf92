"""The port's stage-1 SwinIR trainer against the JAX package, fp32 on the CPU.

The train step and the val step against ``diffbir_tpu/train/stage1.py`` on
the tiny SwinIR of ``tests/test_parallel.py`` (embed 16, depths (1,), heads
(2,), window 4, 32x32), the JAX parameters carried across by the port's
converter: the loss of each of two steps within STEP_TOL x its size, the
parameters after them within PARAM_TOL x max(1, max|ref|) of JAX's. The
optimiser alone against optax.adamw's default (weight decay 1e-4) on the
same gradients within OPT_TOL x max|ref|, where weight decay 0 must fail:
in the whole step the decay (lr x 1e-4 x |p| a step) is far below what
fp32's summation order does to Adam's update where a gradient nearly
cancels, so only the optimiser alone can tell it apart. Then the loop
through ``train_stage1.main`` on tiny PNGs: the log and val lines, three
checkpoints kept, a resume restoring the masters and AdamW moments bit for
bit, and ``resume: 0`` training from step 0.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.models.swinir import SwinIR as JaxSwinIR
from diffbir_tpu.train import stage1 as jax_stage1
from diffbir_tpu_torch import train_stage1
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.train import stage1
from diffbir_tpu_torch.utils.image_io import write_png
from diffbir_tpu_torch.weights.convert import flax_to_state_dict
from tests.test_torch_models import fill_params, load_port

SWIN = dict(embed_dim=16, depths=(1,), num_heads=(2,), window_size=4)
HEAD = dict(sf=8, unshuffle=True, unshuffle_scale=8)
LR, SIZE, BATCH = 1e-4, 32, 2
# fp32: JAX and the port sum the same products in another order: the losses
# agree to ~1e-6 relative, and after two AdamW steps (each moving a
# parameter by up to ~lr) the parameters to 2.1e-7 at max|ref| 1.6 (measured
# on the CPU); the limits are ~10x and ~5x those. The k part of the qkv bias
# is left out: softmax ignores a constant added to every key's logit, so its
# true gradient is 0 and Adam's update of it is lr x (rounding noise over
# |rounding noise| + eps), different in every implementation.
STEP_TOL, PARAM_TOL = 1e-5, 1e-6
K_BIAS = "layers.0.residual_group.blocks.0.attn.qkv.bias"
# the optimiser alone on identical gradients: the same elementwise math in
# another order, a few fp32 ulps of the parameters (1.4e-6 at |p| ~6.6,
# measured); weight decay moves them by lr x 1e-4 x |p| a step, 6.6e-5 here
OPT_LR, OPT_TOL = 1e-1, 1e-6


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX train steps and a val step from seeded parameters; the port
    gets the same parameters and batches."""
    model = JaxSwinIR(**SWIN, **HEAD)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    params = fill_params(shapes, seed=5)
    rng = np.random.default_rng(11)
    batches = [{"gt": rng.random((BATCH, SIZE, SIZE, 3)).astype(np.float32),
                "lq": rng.random((BATCH, SIZE, SIZE, 3)).astype(np.float32)} for _ in range(2)]
    opt = jax_stage1.make_optimizer(LR)
    state = jax_stage1.init_state(jax.tree_util.tree_map(jnp.asarray, params), opt)
    step = jax.jit(jax_stage1.make_train_step(model.apply, opt))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    val = jax.jit(jax_stage1.make_val_step(model.apply))(state.params, batches[0])
    after = {k: v.numpy() for k, v in flax_to_state_dict(jax.device_get(state.params)).items()}
    return params, batches, losses, after, {k: float(v) for k, v in val.items()}


def port_steps(params, batches, weight_decay=stage1.WEIGHT_DECAY):
    model = load_port(SwinIR(**SWIN), params)
    opt = stage1.init_train_state(model, LR, weight_decay)
    step = stage1.make_train_step(model, opt)
    losses = [float(step({k: torch.from_numpy(v) for k, v in b.items()})["loss"])
              for b in batches]
    names = [n for n, _ in model.named_parameters()]
    return model, losses, dict(zip(names, (m.numpy() for m in opt.masters)))


def without_k_bias(d):
    d = dict(d)
    dim = d[K_BIAS].shape[0] // 3
    d[K_BIAS] = np.concatenate([d[K_BIAS][:dim], d[K_BIAS][2 * dim:]])
    return d


def test_train_and_val_steps_match_jax(jax_run):
    params, batches, ref_losses, after, ref_val = jax_run
    model, losses, got = port_steps(params, batches)
    for ref, loss in zip(ref_losses, losses):
        assert abs(loss - ref) <= STEP_TOL * abs(ref), (loss, ref)
    after, got = without_k_bias(after), without_k_bias(got)
    assert sorted(after) == sorted(got)
    err = max(float(np.abs(after[k] - got[k]).max()) for k in after)
    bound = PARAM_TOL * max(1.0, max(float(np.abs(v).max()) for v in after.values()))
    assert err <= bound, f"params after two steps: max abs err {err} > {bound}"
    val = stage1.make_val_step(model)({k: torch.from_numpy(v) for k, v in batches[0].items()})
    assert float(val["psnr"]) == pytest.approx(ref_val["psnr"], rel=1e-6)
    assert float(val["mse"]) == pytest.approx(ref_val["mse"], rel=1e-5)


def optimizer_error(weight_decay):
    """Three updates of optax (the JAX stage-1 optimiser) and of the port's
    MasterAdamW from the same parameters on the same gradients."""
    import optax

    rng = np.random.default_rng(3)
    shapes = [(16, 8), (8,), (3, 3, 4, 4)]
    params = [rng.standard_normal(s).astype(np.float32) * 2 for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    opt = jax_stage1.make_optimizer(OPT_LR)
    ref = [jnp.asarray(p) for p in params]
    state = opt.init(ref)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, ref)
        ref = optax.apply_updates(ref, upd)
    tensors = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    mopt = stage1.MasterAdamW(tensors, OPT_LR, weight_decay=weight_decay)
    for g in grads:
        for t, x in zip(tensors, g):
            t.grad = torch.from_numpy(x)
        mopt.step()
    err = max(float(np.abs(np.asarray(r) - m.numpy()).max()) for r, m in zip(ref, mopt.masters))
    return err, OPT_TOL * max(float(np.abs(np.asarray(r)).max()) for r in ref)


def test_optimizer_matches_optax_adamw_default_decay():
    err, bound = optimizer_error(stage1.WEIGHT_DECAY)
    assert err <= bound, f"max abs err {err} > {bound}"


def test_without_weight_decay_fails_the_limit():
    """optax.adamw's default decay 1e-4 is part of stage 1's optimiser: the
    port at weight decay 0 (stage 2's) lands outside the limit."""
    err, bound = optimizer_error(0.0)
    assert err > 10 * bound, f"weight decay 0 reads {err}, within 10 x {bound}"


# --------------------------------------------------------------------------- #
# the loop: python -m diffbir_tpu_torch.train_stage1 on tiny PNGs
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
"""
CONFIG = """\
model:
  swinir:
    target: diffbir_tpu.models.swinir.SwinIR
    params:
      img_size: 64
      in_chans: 3
      embed_dim: 16
      depths: [1]
      num_heads: [2]
      window_size: 4
      mlp_ratio: 2
      sf: 8
      img_range: 1.0
      upsampler: "nearest+conv"
      resi_connection: "1conv"
      unshuffle: true
      unshuffle_scale: 8

dataset:
  train:
{train}  val:
{val}
train:
  learning_rate: 1e-3
  batch_size: 2
  train_steps: {steps}
  log_every: 1
  val_every: 2
  val_batches: 2
  ckpt_every: {ckpt_every}
  resume: {resume}
  exp_dir: {exp}
  seed: 231
  n_data: null
{extra}"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Five 40x36 PNGs (center-cropped to 32) and a txt list."""
    root = tmp_path_factory.mktemp("stage1")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(5):
        path = str(root / f"img{i}.png")
        write_png(path, rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
        lines.append(f"{path}\ta face {i}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return root


def write_config(files, exp, steps=4, ckpt_every=1, resume="null", extra=""):
    exp.mkdir(exist_ok=True)
    ds = DATASET.format(flist=files / "list.txt")
    path = exp / "train.yaml"
    path.write_text(CONFIG.format(train=ds, val=ds, steps=steps, ckpt_every=ckpt_every,
                                  resume=resume, exp=exp, extra=extra))
    return str(path)


def run(cfg_path):
    return train_stage1.main(["--config", cfg_path, "--device", "cpu"])


@pytest.fixture(scope="module")
def trained(files, tmp_path_factory):
    exp = tmp_path_factory.mktemp("exp1")
    return exp, run(write_config(files, exp))


def test_logs_validation_and_checkpoints(files, tmp_path, capsys):
    exp = tmp_path / "exp"
    trainer = run(write_config(files, exp))
    out = capsys.readouterr().out
    for s in range(1, 5):
        assert f"step {s}: loss=" in out and "images/s=" in out
    assert "step 2: val psnr=" in out and "(2 batches)" in out and "step 4: val psnr=" in out
    assert trainer.step == 4 and len(trainer.losses) == 4 and len(trainer.val_psnr) == 2
    assert all(np.isfinite(trainer.losses)) and all(np.isfinite(trainer.val_psnr))
    assert sorted(os.listdir(exp / "checkpoints")) == ["2.pt", "3.pt", "4.pt"]
    saved = torch.load(str(exp / "checkpoints" / "4.pt"), weights_only=True)
    assert saved["step"] == 4 and saved["updates"] == 4
    for m, s in zip(trainer.optimizer.masters, saved["masters"]):
        assert torch.equal(m, s)
    assert trainer.optimizer.optimizer.param_groups[0]["weight_decay"] == stage1.WEIGHT_DECAY


def test_resume_restores_state_bit_for_bit(trained, files, tmp_path):
    exp = tmp_path / "exp"
    shutil.copytree(trained[0], exp)
    saved = torch.load(str(exp / "checkpoints" / "3.pt"), weights_only=True)
    cfg = train_stage1.cfglib.load_yaml(write_config(files, exp, steps=5, resume=3))
    trainer = train_stage1.Stage1Trainer(cfg, "cpu")
    assert trainer.step == 3
    for m, p, s in zip(trainer.optimizer.masters, trainer.model.parameters(), saved["masters"]):
        assert torch.equal(m, s) and torch.equal(p, s)
    state = trainer.optimizer.optimizer.state_dict()["state"]
    for i, s in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state[i][key], s[key]), (i, key)
    trainer.run()
    assert trainer.step == 5 and len(trainer.losses) == 2
    assert sorted(os.listdir(exp / "checkpoints")) == ["3.pt", "4.pt", "5.pt"]


def test_resume_zero_trains_from_step_zero(files, tmp_path):
    """``resume: 0`` is falsy: JAX's ``if tcfg.get("resume")`` starts fresh."""
    trainer = run(write_config(files, tmp_path / "exp", steps=2, resume=0))
    assert trainer.step == 2 and len(trainer.losses) == 2
    assert sorted(os.listdir(tmp_path / "exp" / "checkpoints")) == ["1.pt", "2.pt"]


def test_last_checkpoint_between_intervals_and_same_init(trained, files, tmp_path):
    """A loop ending between checkpoints saves a last one; the model's
    initial weights depend only on train.seed (the first loss repeats)."""
    trainer = run(write_config(files, tmp_path / "exp", steps=3, ckpt_every=2))
    assert sorted(os.listdir(tmp_path / "exp" / "checkpoints")) == ["2.pt", "3.pt"]
    assert trainer.losses[:3] == trained[1].losses[:3]


def _with(path, old, new):
    with open(path) as f:
        text = f.read()
    assert old in text
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    return path


def test_n_data_batch_and_missing_resume_raise(files, tmp_path):
    """train.n_data must be null or the process count (1 here), the batch
    must divide by it, and a missing checkpoint names itself."""
    with pytest.raises(ValueError, match="n_data"):
        run(_with(write_config(files, tmp_path / "a"), "n_data: null", "n_data: 2"))
    with pytest.raises(FileNotFoundError, match="7.pt"):
        run(write_config(files, tmp_path / "b", resume=7))


def test_cuda_without_a_card_raises(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_stage1.main(["--config", write_config(files, tmp_path / "exp")])
