"""The traffic generator: the same seed gives the same inputs, lengths
stay in their ranges and every batch spans the whole lattice."""

import torch

from portbench import traffic

MIX = {"N": 6, "T": 20, "U": 7, "V": 11, "frames": [10, 20],
       "labels": [3, 6], "pool": 3, "feat_dim": 4}


def _draw(seed):
    gen = traffic.generator(seed, "cpu")
    return traffic.log_probs(MIX, gen, "cpu", block=4), \
        traffic.pool(MIX, gen, "cpu")


def test_same_seed_same_inputs():
    a_lp, a_pool = _draw(2**31 + 17)
    b_lp, b_pool = _draw(2**31 + 17)
    assert torch.equal(a_lp, b_lp)
    for a, b in zip(a_pool, b_pool):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])


def test_other_seed_other_inputs():
    a_lp, a_pool = _draw(5)
    b_lp, b_pool = _draw(6)
    assert not torch.equal(a_lp, b_lp)
    assert not torch.equal(a_pool[0]["labels"], b_pool[0]["labels"])


def test_ranges_and_first_full():
    lp, pool = _draw(3)
    assert lp.shape == (6, 20, 7, 11)
    assert torch.allclose(lp.exp().sum(-1), torch.ones(6, 20, 7))
    assert len(pool) == 3
    for b in pool:
        assert b["xn"][0] == 20 and b["yn"][0] == 6
        assert int(b["xn"].min()) >= 10 and int(b["xn"].max()) <= 20
        assert int(b["yn"].min()) >= 3 and int(b["yn"].max()) <= 6
        assert b["labels"].shape == (6, 6)
        assert int(b["labels"].min()) >= 1 and int(b["labels"].max()) < 11
        assert b["feats"].shape == (6, 20, 4)
        assert b["xn"].dtype == torch.int32


def test_seeds_past_32_bits():
    gen = traffic.generator(2**40 + 3, "cpu")
    assert traffic.pool(MIX, gen, "cpu")[0]["xn"].shape == (6,)
