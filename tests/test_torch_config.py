"""The port's config system (``diffbir_tpu_torch/config.py``) on the CPU.

- ``load_yaml`` equals ``yaml.safe_load`` on every train config of the
  repository and on hand-written cases of the YAML 1.1 scalar rules
  (``1e-4`` a string, ``1.0e-4`` a float, ``yes``/``off`` bools, ``~``
  null, octal, hex, base 60, ``.inf``), quoting, comments, flow and block
  collections; what it does not read raises ValueError naming the line;
- ``resolve`` reads a ``diffbir_tpu.*`` target as the port's class, keeps
  registered short names, refuses other roots, and names a target whose
  module is not ported; ``instantiate`` builds the train configs' SwinIR.
"""

import glob
import math
import os

import pytest
import yaml

from diffbir_tpu_torch import config
from diffbir_tpu_torch.dataset.codeformer import CodeformerDataset
from diffbir_tpu_torch.models.scunet import SCUNet
from diffbir_tpu_torch.models.swinir import SwinIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CFGS = sorted(glob.glob(os.path.join(ROOT, "configs", "train", "*.yaml")))


def test_the_repository_has_its_train_configs():
    assert [os.path.basename(p) for p in TRAIN_CFGS] == [
        "train_stage1.yaml", "train_stage2.yaml", "train_stage2_v2.1.yaml"]


@pytest.mark.parametrize("path", TRAIN_CFGS, ids=os.path.basename)
def test_load_yaml_equals_safe_load_on_the_train_configs(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    got = config.load_yaml(path)
    assert got == ref
    assert isinstance(got["train"]["learning_rate"], str)  # YAML 1.1: 1e-4, 1e-5


CASES = [
    "a: 1e-4", "a: 1.0e-4", "a: 1.0e4", "a: 12e3", "a: 1.", "a: .5", "a: +.5", "a: 1_2.3_4",
    "a: yes", "a: No", "a: ON", "a: off", "a: True", "a: TRUE", "a: tRue",
    "a: ~", "a:", "a: null", "a: Null",
    "a: 0x1F", "a: 0b101", "a: 017", "a: 09", "a: 00", "a: 1_000", "a: +12", "a: -0",
    "a: 1:30", "a: -1:30.5", "a: .inf", "a: -.Inf", "a: 0o7",
    "a: 'it''s # not a comment'", 'a: "x\\ty \\"q\\""', "a: b # c\n# d\ne: f#g",
    "a: http://x.y/z:1", "'k: 1': v", "1: one", "a: x - y",
    "a: [1, 'b', c d, 2.5, [3, 4], {}]", "a: {x: 1, y: [2, yes]}", "a: {}", "a: []",
    "a:\n- 1\n- 2", "a:\n  - x: 1\n    y: [2]\n  - 3\n  -\n    - 4", "- a\n- b",
    "- - 1\n  - 2\n- 3",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3", "", "# only a comment\n",
]


@pytest.mark.parametrize("text", CASES)
def test_parse_yaml_equals_safe_load(text):
    ref = yaml.safe_load(text)
    got = config.parse_yaml(text)
    assert got == ref and type(got) is type(ref)
    if isinstance(ref, dict) and isinstance(ref.get("a"), float):
        assert math.copysign(1.0, got["a"]) == math.copysign(1.0, ref["a"])


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &x 2", 2), ("a: *x", 1), ("a: !!int 3", 1), ("a: |\n  text", 1),
    ("a: >\n  text", 1), ("---\na: 1", 1), ("a: [1,\n  2]", 1), ("a: 2024-01-02", 1),
    ("<<: {b: 1}", 1), ("a: 1\n  b: 2", 2), ("a: b: c", 1), ("a: 'open", 1),
    ("a:\n\tb: 1", 2), ("a: -", 1), ("a: [1, , 2]", 1),
])
def test_what_it_does_not_read_raises_naming_the_line(text, line):
    """Anchors, aliases, tags, block scalars, documents, multi-line flow, dates
    and merge keys (which PyYAML reads), and malformed YAML (which it
    refuses too)."""
    with pytest.raises(ValueError, match=f"<yaml>:{line}:"):
        config.parse_yaml(text)


def test_load_yaml_wants_a_mapping(tmp_path):
    path = tmp_path / "list.yaml"
    path.write_text("- 1\n- 2\n")
    with pytest.raises(ValueError, match="expected a YAML mapping"):
        config.load_yaml(str(path))


def test_resolve_reads_the_jax_targets_as_the_ports():
    assert config.resolve("diffbir_tpu.models.swinir.SwinIR") is SwinIR
    assert config.resolve("diffbir_tpu_torch.models.scunet.SCUNet") is SCUNet
    assert config.resolve("diffbir_tpu.models.scunet.SCUNet") is SCUNet
    assert config.resolve("diffbir_tpu.dataset.codeformer.CodeformerDataset") is \
        CodeformerDataset


def test_resolve_refuses_other_roots_and_names_unported_modules():
    for target in ("os.system", "jax.numpy.zeros", "diffbir_tpu2.models.X", "torch.nn.Linear"):
        with pytest.raises(ValueError, match="must be a registered name"):
            config.resolve(target)
    with pytest.raises(KeyError, match="unknown registry name"):
        config.resolve("no_such_name")
    # utils/jax_cache.py is one of the JAX package's TPU-only modules the
    # port leaves out (every other module is ported)
    with pytest.raises(NotImplementedError, match="diffbir_tpu_torch.utils.jax_cache"):
        config.resolve("diffbir_tpu.utils.jax_cache.enable_persistent_cache")


def test_registered_short_names_stay_short(monkeypatch):
    monkeypatch.setattr(config, "_REGISTRY", {})
    marker = config.register("tiny_thing")(type("Tiny", (), {}))
    assert config.resolve("tiny_thing") is marker
    with pytest.raises(ValueError, match="duplicate"):
        config.register("tiny_thing")(type("Other", (), {}))


def test_instantiate_builds_the_train_configs_swinir():
    cfg = config.load_yaml(TRAIN_CFGS[-1])["model"]["swinir"]
    model = config.instantiate(cfg, device="meta")
    assert isinstance(model, SwinIR) and len(model.layers) == 8
    bad = {**cfg, "params": {**cfg["params"], "upsampler": "pixelshuffle"}}
    with pytest.raises(NotImplementedError, match="upsampler"):
        config.instantiate(bad, device="meta")
    with pytest.raises(KeyError, match="target"):
        config.instantiate({"params": {}})
