"""The operation and byte counts against counts by hand at one small
shape."""
import pytest

from perfbench.work import counts, peaks

CFG = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
       "intermediate_size": 96, "vocab_size": 100, "num_hidden_layers": 3,
       "port": {"block_size": 16}}
MOE = dict(CFG, num_local_experts=4, num_experts_per_tok=2)


def test_token_linear_flops():
    d, hd, f = 64, 16, 96
    attn = d * 4 * hd + 2 * d * 2 * hd + 4 * hd * d
    assert counts.token_linear_flops(CFG) == 2 * 3 * (attn + 3 * d * f)
    assert counts.token_linear_flops(MOE) == \
        2 * 3 * (attn + d * 4 + 2 * 3 * d * f)


def test_prefill_and_decode_flops():
    n, dens = 64, 0.5
    attn = 4 * 16 * 4 * dens * n * (n + 1) / 2
    strip = 2 * 4 * 16 * n * 16
    want = n * counts.token_linear_flops(CFG) + 3 * (attn + strip) \
        + 2 * 64 * 100
    assert counts.prefill_flops(CFG, n, dens) == pytest.approx(want)
    assert counts.decode_flops(CFG, 70) == pytest.approx(
        counts.token_linear_flops(CFG) + 3 * 4 * 16 * 4 * 70 + 2 * 64 * 100)


def test_strip_work():
    n = 64
    flops, nbytes = counts.strip_work(CFG, n)
    assert flops == 3 * 2 * 4 * 16 * n * 16
    assert nbytes == 3 * (2 * (4 * 16 * 16 + 2 * n * 16) + 4 * 4 * 16 * n)


def test_bsa_work_counts_kept_entries():
    n, bs = 64, 16                      # 4 blocks, 10 causal
    # every causal block kept: each (query, key) entry with key <= query
    flops, nbytes = counts.bsa_work(CFG, n, 1.0, dense_heads=1)
    entries = n * (n + 1) / 2
    assert flops == pytest.approx(3 * 4 * 16 * 4 * entries)
    assert nbytes == pytest.approx(
        3 * (2 * (2 * 4 + 2 * 2) * n * 16 + 4 * 1 * 4 * 4))
    # the diagonal alone (density 4 / 10)
    flops, _ = counts.bsa_work(CFG, n, 0.4, dense_heads=0)
    assert flops == pytest.approx(3 * 4 * 16 * 4 * 4 * bs * (bs + 1) / 2)


def test_roofline_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(989e12, 2 * 3.35e12) == pytest.approx(2.0)
