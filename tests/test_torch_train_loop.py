"""The port's file-driven stage-2 trainer (``python -m
diffbir_tpu_torch.train_stage2``) on the CPU at ``ControlLDM.tiny`` and a
tiny SwinIR, for a few steps on a PNG folder the test writes.

JAX's ``train_stage2.py`` hard-codes ``sd21``, so the loop itself has no
JAX twin at a test's size; its parts are held against JAX elsewhere (the
data and the transform in ``test_torch_dataset.py``, the step in
``test_torch_train.py``). The model factory is the only seam. Checked here:
the ``log_every`` lines, the checkpoint files and the three newest kept;
``resume`` restoring the masters, the AdamW moments and the step bit for
bit, then training on; ``controlnet_<step>.pth`` loading with
``load_state_dict(strict=True)`` into the custom loop's ControlNet and
holding the masters; the ControlNet initialised from the UNet (other
tensors zero), the frozen models unchanged; the preview; ``resume: 0``
training from step 0, as JAX's truthy test does; ``fsdp`` and
``native_loader``, once refused, now training; and the refusals (an
incomplete multi-process environment, a ``.parquet`` list, a missing
checkpoint to resume); the trainer's own spans (``utils.spans``: each
step's ``train.data_wait`` and ``train.step``, each checkpoint's
``train.save``, the step's phases under its ``train.step``), which its
``step_seconds``, ``wait_seconds`` and ``save_seconds`` read, with the
recorder on and off. Several processes: ``test_torch_parallel.py``.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from diffbir_tpu_torch import train_stage2
from diffbir_tpu_torch.models import tokenizer
from diffbir_tpu_torch.models.cldm import ControlLDM
from diffbir_tpu_torch.models.layers import random_init_
from diffbir_tpu_torch.models.swinir import SwinIR
from diffbir_tpu_torch.utils import spans
from diffbir_tpu_torch.utils.image_io import write_png
from diffbir_tpu_torch.weights.convert import SD_MODULE_MAP

SWIN = dict(embed_dim=16, depths=[1], num_heads=[2], window_size=4, mlp_ratio=2)
CONFIG = """\
model:
  zero_snr: true
  parameterization: v
  cldm:
    use_checkpoint: true
  swinir:
    target: diffbir_tpu.models.swinir.SwinIR
    params:
      img_size: 64
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
    target: realesrgan_dataset
    params:
      file_metas:
        - file_list: {flist}
      out_size: 64
      crop_type: none
      use_hflip: true
      p_empty_prompt: 0.2

batch_transform:
  target: realesrgan_batch_transform
  params:
    use_sharpener: true
    queue_size: 4
    resize_prob: [0.2, 0.7, 0.1]
    resize_range: [0.3, 1.5]
    gray_noise_prob: 0.4
    gaussian_noise_prob: 0.5
    noise_range: [1, 15]
    poisson_scale_range: [0.05, 2.0]
    jpeg_range: [60, 95]
    second_blur_prob: 0.5
    stage2_scale: 4
    resize_prob2: [0.3, 0.4, 0.3]
    resize_range2: [0.6, 1.2]
    gray_noise_prob2: 0.4
    gaussian_noise_prob2: 0.5
    noise_range2: [1, 12]
    poisson_scale_range2: [0.05, 1.0]
    jpeg_range2: [60, 95]

train:
  sd_path: {sd}
  swinir_path: {swin}
  learning_rate: 1e-3
  batch_size: 2
  train_steps: {steps}
  noise_aug_timestep: 200
  log_every: 1
  ckpt_every: {ckpt_every}
  image_every: 1000
  resume: {resume}
  exp_dir: {exp}
  seed: 231
{extra}"""
PROMPTS = ["a red house by the sea", "a dog on grass", "city lights at night",
           "a bowl of fruit"]


def tiny_factory(use_checkpoint=False, **kw):
    return ControlLDM.tiny(**kw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The SD base (SD key prefixes) and SwinIR files from seeded random
    tiny models, four 64x64 PNGs with prompts, and a stand-in merges file."""
    root = tmp_path_factory.mktemp("train")
    cldm = ControlLDM.tiny()
    random_init_(cldm, torch.Generator().manual_seed(3))
    sd = {prefix + k: v for name, prefix in SD_MODULE_MAP.items()
          for k, v in getattr(cldm, name).state_dict().items()}
    torch.save({"state_dict": sd}, str(root / "sd.ckpt"))
    swin = random_init_(SwinIR(**SWIN), torch.Generator().manual_seed(4))
    torch.save(swin.state_dict(), str(root / "swinir.pth"))
    rng = np.random.default_rng(0)
    lines = []
    for i, prompt in enumerate(PROMPTS):
        path = str(root / f"img{i}.png")
        write_png(path, rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        lines.append(f"{path}\t{prompt}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    bpe = str(root / "bpe.txt.gz")
    tokenizer.write_stand_in_merges(bpe, PROMPTS)
    return root, cldm


@pytest.fixture()
def env(files, monkeypatch):
    root, _ = files
    monkeypatch.setenv("DIFFBIR_TPU_BPE_PATH", str(root / "bpe.txt.gz"))
    tokenizer.get_tokenizer.cache_clear()
    yield
    tokenizer.get_tokenizer.cache_clear()


def write_config(files, exp, steps=4, ckpt_every=1, resume="null", extra="", flist=None):
    root, _ = files
    path = exp / "train.yaml"
    exp.mkdir(exist_ok=True)
    path.write_text(CONFIG.format(flist=flist or root / "list.txt", sd=root / "sd.ckpt",
                                  swin=root / "swinir.pth", steps=steps, ckpt_every=ckpt_every,
                                  resume=resume, exp=exp, extra=extra))
    return str(path)


def run(cfg_path):
    return train_stage2.main(["--config", cfg_path, "--device", "cpu"], cldm_factory=tiny_factory)


@pytest.fixture(scope="module")
def trained(files, tmp_path_factory):
    """Four steps, a checkpoint every step."""
    exp = tmp_path_factory.mktemp("exp")
    mp = pytest.MonkeyPatch()
    mp.setenv("DIFFBIR_TPU_BPE_PATH", str(files[0] / "bpe.txt.gz"))
    tokenizer.get_tokenizer.cache_clear()
    try:
        trainer = run(write_config(files, exp))
    finally:
        mp.undo()
        tokenizer.get_tokenizer.cache_clear()
    return exp, trainer


def test_logs_and_checkpoints(trained, files, capsys):
    exp, trainer = trained
    assert trainer.step == 4 and len(trainer.losses) == 4
    assert all(np.isfinite(trainer.losses)) and len(trainer.wait_seconds) == 4
    assert len(trainer.step_seconds) == 4 and len(trainer.save_seconds) == 4
    assert sorted(os.listdir(exp / "checkpoints")) == ["2.pt", "3.pt", "4.pt"]
    assert all((exp / f"controlnet_{s}.pth").is_file() for s in range(1, 5))
    # the frozen models are the files'; the ControlNet moved from the UNet
    src = files[1]
    for name in SD_MODULE_MAP:
        for k, v in getattr(src, name).state_dict().items():
            assert torch.equal(getattr(trainer.cldm, name).state_dict()[k], v), (name, k)
    assert not torch.equal(trainer.cldm.controlnet.state_dict()["time_embed.0.weight"],
                           src.unet.state_dict()["time_embed.0.weight"])


def test_trainer_spans(trained):
    _, trainer = trained
    own = sorted(trainer.wait_spans + trainer.step_spans + trainer.save_spans,
                 key=lambda s: s.start_ns)
    assert [s.name for s in own] == ["train.data_wait", "train.step", "train.save"] * 4
    assert all(a.end_ns <= b.start_ns for a, b in zip(own, own[1:]))
    ring = spans.snapshot()
    for step in trainer.step_spans:
        assert step in ring
        phases = [s for s in ring if s.parent == step.id]
        assert [s.name for s in phases] == ["train.forward", "train.backward",
                                            "train.optimizer"]
        assert all(step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns for s in phases)
        assert sum(s.host_ms for s in phases) <= step.host_ms
    assert trainer.step_seconds == [s.host_ms / 1e3 for s in trainer.step_spans]
    assert trainer.save_seconds == [s.host_ms / 1e3 for s in trainer.save_spans]


def test_trainer_times_with_the_recorder_off(files, env, tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "_enabled", False)
    t0 = time.perf_counter_ns()
    trainer = run(write_config(files, tmp_path / "exp", steps=2, ckpt_every=2))
    assert len(trainer.step_seconds) == len(trainer.wait_seconds) == 2
    assert len(trainer.save_seconds) == 1 and all(v > 0 for v in trainer.step_seconds)
    assert [s for s in spans.snapshot() if s.start_ns >= t0] == []


def test_controlnet_init_from_unet(files, tmp_path, env):
    exp = tmp_path / "exp"
    cfg = train_stage2.cfglib.load_yaml(write_config(files, exp, steps=0))
    trainer = train_stage2.Stage2Trainer(cfg, "cpu", tiny_factory)
    unet = files[1].unet.state_dict()
    for k, v in trainer.cldm.controlnet.state_dict().items():
        if k in unet and unet[k].shape == v.shape:
            assert torch.equal(v, unet[k]), k
        elif k not in unet:
            assert float(v.abs().sum()) == 0.0, k  # the zero convs, as JAX's zero tree


def test_resume_restores_state_bit_for_bit(trained, files, tmp_path, env):
    exp = tmp_path / "exp"
    shutil.copytree(trained[0], exp)  # the shared run's files stay as they were
    saved = torch.load(str(exp / "checkpoints" / "3.pt"), weights_only=True)
    cfg = train_stage2.cfglib.load_yaml(write_config(files, exp, steps=5, resume=3))
    trainer = train_stage2.Stage2Trainer(cfg, "cpu", tiny_factory)
    assert trainer.step == 3
    for m, s in zip(trainer.optimizer.masters, saved["masters"]):
        assert torch.equal(m, s)
    for p, s in zip(trainer.cldm.controlnet.parameters(), saved["masters"]):
        assert torch.equal(p, s)  # fp32 on the CPU: the module holds the masters
    state = trainer.optimizer.optimizer.state_dict()["state"]
    for i, s in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state[i][key], s[key]), (i, key)
    trainer.run()
    assert trainer.step == 5 and len(trainer.losses) == 2
    assert sorted(os.listdir(exp / "checkpoints")) == ["3.pt", "4.pt", "5.pt"]


def test_deployable_loads_into_the_custom_loops_controlnet(trained):
    exp, trainer = trained
    sd = torch.load(str(exp / "controlnet_4.pth"), weights_only=True)
    target = ControlLDM.tiny().controlnet
    target.load_state_dict(sd, strict=True)
    for p, m in zip(target.parameters(), trainer.optimizer.masters):
        assert torch.equal(p, m)


def test_last_checkpoint_between_intervals(files, tmp_path, env):
    exp = tmp_path / "exp"
    trainer = run(write_config(files, exp, steps=3, ckpt_every=2))
    assert sorted(os.listdir(exp / "checkpoints")) == ["2.pt", "3.pt"]
    assert sorted(p for p in os.listdir(exp) if p.startswith("controlnet_")) == \
        ["controlnet_2.pth"]
    assert trainer.step == 3


def test_preview(trained):
    _, trainer = trained
    lq = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    tokens = torch.zeros(2, 77, dtype=torch.long)
    out = train_stage2.preview(trainer.cldm, trainer.schedule, trainer.cleaner(lq), tokens,
                               torch.Generator().manual_seed(1), steps=3)
    assert out.shape == (2, 64, 64, 3) and torch.isfinite(out).all()
    assert 0 <= float(out.min()) and float(out.max()) <= 1


def crop_center(cfg_path):
    with open(cfg_path) as f:
        text = f.read()
    with open(cfg_path, "w") as f:
        f.write(text.replace("crop_type: none", "crop_type: center"))
    return cfg_path


@pytest.mark.parametrize("extra,match", [("  fsdp: true\n", "train.fsdp"),
                                         ("  native_loader: true\n", "native_loader")])
def test_unported_options_raise(files, tmp_path, env, extra, match, capsys):
    """The two options this trainer once refused now train. ``train.fsdp``
    in one process: fsdp_spec's rule replicates every leaf, so the
    optimiser state is the plain one. ``train.native_loader``: the PNGs through
    the C++ loader where it builds (center crop: JAX's native path refuses
    crop_type none), else JAX's fallback line and the Python path."""
    cfg = write_config(files, tmp_path / "exp", extra=extra)
    if match == "native_loader":
        crop_center(cfg)
    trainer = run(cfg)
    assert trainer.step == 4 and all(np.isfinite(trainer.losses))
    if match == "train.fsdp":
        assert trainer.parallel.fsdp and all(d is None for d in trainer.optimizer.dims)
    else:
        assert "native C++ data loader: " in capsys.readouterr().out


def test_native_loader_needs_a_crop(files, tmp_path, env):
    from diffbir_tpu_torch.dataset.native_loader import native_available

    if not native_available():
        pytest.skip("the native loader does not build here")
    with pytest.raises(ValueError, match="crop_type"):
        run(write_config(files, tmp_path / "exp", extra="  native_loader: true\n"))


def test_multi_process_environment_raises(files, tmp_path, env, monkeypatch):
    """An incomplete launch environment (the coordinator without the count
    and the rank) raises, naming it."""
    monkeypatch.setenv("DIFFBIR_COORDINATOR", "localhost:1234")
    with pytest.raises(ValueError, match="DIFFBIR_COORDINATOR"):
        run(write_config(files, tmp_path / "exp"))


def test_resume_zero_trains_from_step_zero(files, tmp_path, env):
    """``resume: 0`` is falsy: JAX's ``if tcfg.get("resume")`` starts fresh
    (the port once looked for ``0.pt`` and raised)."""
    trainer = run(write_config(files, tmp_path / "exp", steps=2, resume=0))
    assert trainer.step == 2 and len(trainer.losses) == 2
    assert sorted(os.listdir(tmp_path / "exp" / "checkpoints")) == ["1.pt", "2.pt"]


def test_parquet_list_and_missing_resume_raise(files, tmp_path, env):
    with pytest.raises(ValueError, match="pandas"):
        run(write_config(files, tmp_path / "a", flist="data/train.parquet"))
    with pytest.raises(FileNotFoundError, match="7.pt"):
        run(write_config(files, tmp_path / "b", resume=7))


def test_cuda_without_a_card_raises(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_stage2.main(["--config", write_config(files, tmp_path / "exp")])
