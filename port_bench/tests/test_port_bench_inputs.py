"""The inputs repeat for a seed and differ across seeds, at the same sizes."""

import json

import torch

from port_bench import cells, inputs

TRAFFIC = {"batch": 5, "pool": 3, "domain_factor": 1}


def pool(seed, name="burgers8", **kw):
    cfg = json.loads((cells.BENCH_DIR / "configs" / f"{name}.json").read_text())
    return inputs.make_pool(cfg, dict(TRAFFIC, **kw), seed, "cpu")


def flat(p):
    parts = [b.u0.reshape(-1) for b in p]
    parts += [v.reshape(-1) for b in p if b.forcing for v in b.forcing.values()]
    return torch.cat(parts)


def test_same_seed_same_inputs():
    big = 2 ** 31 + 12345
    assert torch.equal(flat(pool(big)), flat(pool(big)))
    assert torch.equal(flat(pool(7, "ks8")), flat(pool(7, "ks8")))


def test_seeds_differ_in_values_not_sizes():
    a, b = pool(1), pool(2)
    assert [x.u0.shape for x in a] == [x.u0.shape for x in b] == [(5, 128)] * 3
    assert not torch.allclose(flat(a), flat(b))
    assert not torch.equal(a[0].u0, a[1].u0)  # the pool's batches are distinct


def test_domain_factor_widens_grid_and_bands():
    p = pool(3, domain_factor=10)
    assert p[0].u0.shape == (5, 1280)
    k = p[0].forcing["k"].abs()
    assert k.min() >= 30 and k.max() <= 60
    assert pool(3, "ks8")[0].forcing is None
