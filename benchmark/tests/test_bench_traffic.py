"""The traffic generators and the weights are the same for the same seed."""

import numpy as np
import torch

from benchmark.drivers import serve_open_loop, train_steps
from benchmark.lib import weights


def test_lq_images_by_seed():
    a = serve_open_loop.lq_images(np.random.default_rng(2**31 + 9), 3, 16)
    b = serve_open_loop.lq_images(np.random.default_rng(2**31 + 9), 3, 16)
    c = serve_open_loop.lq_images(np.random.default_rng(2**31 + 10), 3, 16)
    assert a.dtype == np.uint8 and a.shape == (3, 16, 16, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_pool_and_draws_by_seed():
    dev = torch.device("cpu")
    p1 = train_steps.make_pool(2**31 + 3, 2, 4, 64, 0.5, 77, dev)
    p2 = train_steps.make_pool(2**31 + 3, 2, 4, 64, 0.5, 77, dev)
    for b1, b2 in zip(p1, p2):
        assert all(torch.equal(b1[k], b2[k]) for k in b1)
    assert not torch.equal(p1[0]["gt"], p1[1]["gt"])  # rows of the pool differ
    assert float(p1[0]["gt"].min()) >= -1 and float(p1[0]["lq"].max()) <= 1
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    d1, d2 = (train_steps.make_draws(g, 4, 8, dev) for g in (g1, g2))
    assert all(torch.equal(d1[k], d2[k]) for k in d1)


def test_weights_by_seed_and_name_order():
    a, b = torch.nn.Linear(8, 4), torch.nn.Linear(8, 4)
    weights.fill_(a.named_parameters(), weights.generator(11, "cpu"))
    weights.fill_(reversed(list(b.named_parameters())), weights.generator(11, "cpu"))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert torch.equal(a.weight, a.weight.to(torch.bfloat16).float())  # bf16 numbers
    norm = torch.nn.LayerNorm(64)
    weights.fill_(norm.named_parameters(), weights.generator(1, "cpu"))
    w, b = norm.weight.detach(), norm.bias.detach()
    assert abs(float(w.mean()) - 1) < 0.05 and abs(float(b.std()) - 0.02) < 0.01
