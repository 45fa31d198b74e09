"""The FLOP and byte counters against numbers worked by hand."""
import pytest

from portbench import harness
from portbench.yardstick import counts


def test_fd_bytes_by_hand():
    # 64 queries x (1,280,000 scores x 4 B + 20 x 8 B)
    assert counts.fd_call_bytes(64, 64 * 20_000, 20) == 327_690_240
    # 64 queries x 64 peers x (20,000 x 4 B + 20 x 8 B)
    assert counts.topk_bytes(64, 64, 20_000, 20) == 328_335_360


def test_granite_flops_by_hand():
    c = harness.cell("granite-train-4k").config["config"]
    # a layer: q 1,048,576 + k, v 524,288 each + o 1,048,576, router
    # 32,768, 8 experts x 3 x 1,024 x 512; 24 layers; head 1,024 x 49,155
    per_layer = 3_145_728 + 32_768 + 12_582_912
    assert counts.active_matmul_params(c) == 24 * per_layer + 50_334_720
    # 6 x 428,608,512 + 12 x 24 x 16 x 64 x 4,097 / 2
    assert counts.train_flops_per_token(c, 4096) == pytest.approx(
        2_571_651_072 + 604_127_232, rel=1e-12)
    assert counts.train_flops_per_token(c, 512) == pytest.approx(
        2_571_651_072 + 12 * 24 * 1024 * 513 / 2, rel=1e-12)
