"""Denoise-loop hoisting in the port against the JAX package, fp32 on the CPU.

The tiny ControlLDM (``ControlLDM.tiny``) with seeded weights, float and in
the int8 layout (the JAX ``quantize_dense_params`` tree, converted). Held:

- the tables: every cross-attention site's context k/v and every ResBlock's
  timestep rows (``make_hoist_tables``) against JAX's ``make_hoist_tables``
  on the same CFG context and the EDM 10-step grid, site by site by module
  path, within 1e-5 x max|ref| (the product of M rows in another order);
- the hoisted forward against the port's in-loop forward, in the default,
  fused and int8 modes, within 1e-5 x max|ref|;
- a wrong-row fault (a step handed the rows of the grid's next timestep)
  must fail that limit, and a timestep off the grid raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffbir_tpu.models import cldm as jax_cldm
from diffbir_tpu_torch.models import cldm as port_cldm
from diffbir_tpu_torch.pipeline import build_sampler
from diffbir_tpu_torch.sampler.base import timestep_vector
from diffbir_tpu_torch.schedule import Schedule
from diffbir_tpu_torch.weights.convert import flax_to_state_dict
from tests.test_torch_models import fill_params

TOL = 1e-5
MODES = {"default": {}, "fused": dict(fused_resblock=True, fused_ffn=True),
         "int8": dict(quant_dense=True, fused_resblock=True, quant_conv=True)}


def _limit(ref):
    return TOL * float(np.abs(np.asarray(ref)).max())


@pytest.fixture(scope="module")
def trees():
    """{"float": the seeded tree, "int8": its quantised layout}."""
    float_params = fill_params(jax_cldm.ControlLDM.tiny().eval_shapes((8, 8)), seed=0)
    int8 = jax.jit(lambda p: jax_cldm.quantize_conv_params(jax_cldm.quantize_dense_params(p)))
    return {"float": float_params, "int8": jax.device_get(int8(float_params))}


def _tree(mode, trees):
    return trees["int8" if mode == "int8" else "float"]


def _port(mode, trees):
    tc = port_cldm.ControlLDM.tiny(**MODES[mode])
    tc.load_state_dict(flax_to_state_dict(_tree(mode, trees)), strict=True)
    return tc.eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)  # cond then uncond
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    c_img = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    grid = build_sampler("edm_dpm++_3m_sde", Schedule.v21(), False).model_ts(10)
    return ctx, x, c_img, grid


def _by_name(cldm, tables):
    """{"unet.<module path>.kv" or ".emb_out": value}: the JAX hoisted
    tree's paths (emb_out as its [T, Cout] first-batch rows)."""
    names = {m: f"{prefix}.{name}" for prefix, root in (("unet", cldm.unet),
                                                         ("controlnet", cldm.controlnet))
             for name, m in root.named_modules()}
    out = {names[m] + ".kv": v.numpy() for m, v in tables.kv.items()}
    out.update({names[m] + ".emb_out": v[:, 0].numpy() for m, v in tables.emb.items()})
    return out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("mode", ["default", "int8"])
def test_tables_match_jax(mode, trees, inputs):
    ctx, _, _, grid = inputs
    jc = jax_cldm.ControlLDM.tiny(**{k: v for k, v in MODES[mode].items() if k != "fused_ffn"})
    params = jax.tree_util.tree_map(jnp.asarray, _tree(mode, trees))
    ref = jax.jit(lambda p, c: jc.make_hoist_tables(p, c, grid))(params, jnp.asarray(ctx))
    ref_flat = dict(_flat(ref["kv"]))
    ref_flat.update((k, v[:, 0]) for k, v in _flat(ref["emb"]))  # [T, 1, co] -> [T, co]
    cldm = _port(mode, trees)
    tables = cldm.make_hoist_tables(torch.from_numpy(ctx), grid)
    got = _by_name(cldm, tables)
    assert set(got) == set(ref_flat)
    assert len(tables.ts) == 11
    np.testing.assert_array_equal(np.asarray(tables.ts, np.float32), np.asarray(ref["ts"]))
    for name, r in ref_flat.items():
        assert got[name].shape == r.shape, name
        err = np.abs(got[name] - r).max()
        assert err <= _limit(r), (name, err, _limit(r))


def _call(cldm, inputs, t, hoisted=None):
    ctx, x, c_img, _ = inputs
    xt = torch.from_numpy(x)
    cond = {"c_txt": torch.from_numpy(ctx), "c_img": torch.from_numpy(c_img)}
    with torch.no_grad():
        return cldm(xt, timestep_vector(t, xt), cond, control_scales=0.7,
                    hoisted=hoisted).numpy()


@pytest.mark.parametrize("mode", list(MODES))
def test_hoisted_forward_matches_the_loop(mode, trees, inputs):
    cldm = _port(mode, trees)
    ctx, _, _, grid = inputs
    tables = cldm.make_hoist_tables(torch.from_numpy(ctx), grid)
    for t in (float(grid[0]), float(grid[5])):
        ref = _call(cldm, inputs, t)
        out = _call(cldm, inputs, t, tables.lookup(t))
        assert np.abs(out - ref).max() <= _limit(ref), (t, np.abs(out - ref).max())
    kv_only = cldm.make_hoist_tables(torch.from_numpy(ctx))  # no grid: the loop embeds t
    out = _call(cldm, inputs, 417.0, kv_only.lookup(417.0))
    ref = _call(cldm, inputs, 417.0)
    assert np.abs(out - ref).max() <= _limit(ref)


def test_a_wrong_row_fails_the_limit(trees, inputs):
    cldm = _port("default", trees)
    ctx, _, _, grid = inputs
    tables = cldm.make_hoist_tables(torch.from_numpy(ctx), grid)
    t = float(grid[3])
    ref = _call(cldm, inputs, t)
    out = _call(cldm, inputs, t, tables.lookup(float(grid[4])))  # the planted fault
    assert np.abs(out - ref).max() > 10 * _limit(ref)
    with pytest.raises(KeyError, match="not on the hoisted grid"):
        tables.lookup(417.0)
