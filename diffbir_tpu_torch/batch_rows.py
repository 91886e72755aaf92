"""Whether a row of the tiled model call depends on the other rows of its batch.

The tiled diffusion stacks ``tiles_per_batch`` latent tiles on the batch
axis, so a model call at three tiles runs at batch 6 (folded CFG). Each
row should come out as it would beside any other rows of the same shape.
This script checks that on a CUDA card, at full width (the SD2.1
ControlLDM, random bf16 weights from seed 0), on the tiled path's inputs: a
128x128 latent at batch 2, the CLI's default prompts through the seeded
stand-in tokenizer (cond, then uncond), a random condition latent, t = 999,
64x64 tiles at stride 32 (``pipeline.tile_model_function``, as the tiled
model call runs them). In order:

1. one call of three different tiles (batch 6), twice on the same input;
2. the same call with its tiles permuted (2, 0, 1), against the first call's
   rows permuted;
3. the three-tile call against three batch-6 calls that each repeat one
   tile, each tile's rows at the same batch position;
4. one call that repeats one tile (the same data in every row block),
   with a hook on every module that runs it again on its inputs with each
   row block made equal to the first: the modules whose own code gives a
   row another value at another batch position, by type and input shape,
   and the bare library op of such a module on such an input.

Each step prints "bit-equal" or the largest difference against the limit
the smoke holds the tiled call to (2^-6 x max|ref|).

Run from the repository root on a machine with a card:

    python3 -m diffbir_tpu_torch.batch_rows [--seed 13]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import torch

from .models.cldm import ControlLDM
from .models.layers import random_init_
from .pipeline import tile_model_function

LAT, TILE, STRIDE, T = 128, 64, 32, 999.0
CORNERS = ((0, 0), (0, 32), (0, 64))
BF16_TOL = 2.0 ** -6


def build(seed: int):
    """The full-width model (seed 0) and the call's inputs (``seed``)."""
    from .profile_step import NEG_PROMPT, POS_PROMPT, stand_in_tokenizer

    gen = torch.Generator(device="cuda").manual_seed(0)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(cldm, gen).eval()
    ids = torch.as_tensor(stand_in_tokenizer()([POS_PROMPT, NEG_PROMPT]), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2, LAT, LAT, 4, generator=gen, device="cuda")
    with torch.no_grad():
        cond = {"c_txt": cldm.encode_text(ids),
                "c_img": torch.randn(2, LAT, LAT, 4, generator=gen, device="cuda")}
    return cldm, x, cond


def tiles_call(model_tile, x, cond, corners) -> torch.Tensor:
    """One model call over the tiles at ``corners``, stacked tile-major."""
    tiles = torch.cat([x[:, hi: hi + TILE, wi: wi + TILE] for hi, wi in corners], dim=0)
    with torch.no_grad():
        return model_tile(tiles, T, cond, tile_coords=tuple(corners)).float()


def compare(out: torch.Tensor, ref: torch.Tensor) -> str:
    if torch.equal(out, ref):
        return "bit-equal"
    err = (out - ref).abs().max().item()
    limit = BF16_TOL * ref.abs().max().item()
    return f"max abs diff {err:.4e} = {err / limit:.3f} of 2^-6 x max|ref|"


def rows(t: torch.Tensor, j: int) -> torch.Tensor:
    return t[2 * j: 2 * j + 2]


def batch_tensors(obj) -> List[torch.Tensor]:
    """The tensors of a module's inputs or output whose first axis is the
    call's batch (6)."""
    if isinstance(obj, torch.Tensor):
        return [obj] if obj.dim() > 0 and obj.shape[0] == 2 * len(CORNERS) else []
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in batch_tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in batch_tensors(o)]
    return []


def map_batch(obj, fn):
    """``obj`` with ``fn`` applied to every tensor whose first axis is the
    call's batch (6)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj) if batch_tensors(obj) else obj
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_batch(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: map_batch(o, fn) for k, o in obj.items()}
    return obj


def blocks_equal(t: torch.Tensor) -> bool:
    return all(torch.equal(rows(t, j), rows(t, 0)) for j in range(1, len(CORNERS)))


def spread(t: torch.Tensor) -> float:
    return max((rows(t, j).float() - rows(t, 0).float()).abs().max().item()
               for j in range(1, len(CORNERS)))


def bisect_positions(cldm, model_tile, x, cond) -> None:
    """Step 4: one call of tile 0 repeated three times, so that every row
    block of every activation should hold the same values. A hook on every
    module runs the module again on its inputs with each batch tensor
    replaced by its block 0 repeated: a module whose output blocks then
    differ gives a row another value at another batch position. Prints the
    modules whose own code does so (no positional module below them), by
    type and input shape, then the bare library op of the first of each
    such type on its input."""
    names = {m: n for n, m in cldm.named_modules()}
    positional: Dict[str, Tuple[str, str, float]] = {}
    examples: Dict[str, Tuple[torch.nn.Module, torch.Tensor]] = {}
    replaying = [False]

    def same_blocks(t):
        return rows(t, 0).repeat((len(CORNERS),) + (1,) * (t.dim() - 1))

    def hook(module, args, kwargs, out):
        if replaying[0]:
            return
        args, kwargs = map_batch(args, same_blocks), map_batch(kwargs, same_blocks)
        replaying[0] = True
        try:
            with torch.no_grad():
                outs = batch_tensors(module(*args, **kwargs))
        finally:
            replaying[0] = False
        bad = [t for t in outs if not blocks_equal(t)]
        if bad:
            ins = batch_tensors((args, kwargs))
            shape = "x".join(map(str, ins[0].shape)) if ins else "-"
            positional[names[module]] = (type(module).__name__, shape, max(map(spread, bad)))
            if ins:
                examples.setdefault(type(module).__name__, (module, ins[0]))

    handles = [m.register_forward_hook(hook, with_kwargs=True) for m in cldm.modules()]
    try:
        tiles_call(model_tile, x, cond, (CORNERS[0],) * len(CORNERS))
    finally:
        for h in handles:
            h.remove()
    own = {n: v for n, v in positional.items()
           if not any(o != n and (not n or o.startswith(n + ".")) for o in positional)}
    total: Dict[str, int] = {}
    for m in cldm.modules():
        if not any(True for _ in m.children()):
            total[type(m).__name__] = total.get(type(m).__name__, 0) + 1
    groups: Dict[Tuple[str, str], List[float]] = {}
    for kind, shape, err in own.values():
        groups.setdefault((kind, shape), []).append(err)
    print(f"[batch_rows] 4. same data at three batch positions: {len(positional)} modules give "
          f"their blocks other values, {len(own)} of them by their own code (leaf modules: "
          + ", ".join(f"{k} {n}" for k, n in sorted(total.items())) + ")")
    for (kind, shape), errs in sorted(groups.items()):
        print(f"[batch_rows] 4.   {kind} on [{shape}]: {len(errs)} modules, blocks apart by up "
              f"to {max(errs):.4e}")
    for kind, (module, x_in) in examples.items():
        if kind in {k for k, _ in groups}:
            bare_op(module, x_in)


def bare_op(module, x: torch.Tensor) -> None:
    """The library op of a positional ``Conv2d`` or ``Linear``, called bare
    on the same block-equal input."""
    import torch.nn.functional as F

    if not isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
        return
    x = x.to(module.weight.dtype)
    with torch.no_grad():
        if isinstance(module, torch.nn.Conv2d):
            label = "F.conv2d"
            out = F.conv2d(x, module.weight, module.bias, module.stride, module.padding)
        else:
            label = "F.linear"
            out = F.linear(x, module.weight, module.bias)
    shapes = " x ".join("[" + "x".join(map(str, t.shape)) + "]" for t in (x, module.weight))
    print(f"[batch_rows] 4. bare {label} {shapes} {str(x.dtype)[6:]}: row blocks "
          + ("bit-equal" if blocks_equal(out) else f"apart by up to {spread(out):.4e}"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=13)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("batch_rows needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[batch_rows] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cudnn {torch.backends.cudnn.version()}, seed {args.seed}")
    cldm, x, cond = build(args.seed)
    model_tile = tile_model_function(cldm, 1.0, TILE)
    n = len(CORNERS)
    mixed = tiles_call(model_tile, x, cond, CORNERS)
    again = tiles_call(model_tile, x, cond, CORNERS)
    print(f"[batch_rows] 1. the three-tile call twice: {compare(again, mixed)}")
    perm = (2, 0, 1)
    permuted = tiles_call(model_tile, x, cond, [CORNERS[i] for i in perm])
    ref = torch.cat([rows(mixed, i) for i in perm])
    print(f"[batch_rows] 2. tiles permuted {perm}: {compare(permuted, ref)}")
    for j in range(n):
        rep = tiles_call(model_tile, x, cond, (CORNERS[j],) * n)
        same = all(torch.equal(rows(rep, i), rows(rep, 0)) for i in range(n))
        print(f"[batch_rows] 3. tile {j}: the three-tile call's rows against the "
              f"repeat call's at the same position: {compare(rows(mixed, j), rows(rep, j))}; "
              f"the repeat call's three copies {'bit-equal' if same else 'differ'}")
    bisect_positions(cldm, model_tile, x, cond)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
