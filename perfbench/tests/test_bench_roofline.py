"""The yardstick's arithmetic at hand-worked shapes, and every share at
most 100% for a time equal to its bound."""


import pytest

from perfbench import roofline as R

D, H, F, K = 256, 2, 1024, 9


def test_block_bound_is_the_smokes_at_padded_rows():
    # chip_smoke.py's block_bound at B=8, T=1000: 54.33 GFLOP (PERF.md's table)
    s, by, flops, nbytes = R.block_bound([1000] * 8, D, H, F, K)
    assert by == "operations"
    assert flops == 8 * 1000 * (2 * D * 3 * D + 4 * 1000 * D + 2 * D * D + 2 * K * D * F + 2 * F * D)
    assert flops / 1e9 == pytest.approx(54.33, abs=0.01)
    assert s == pytest.approx(flops / 989e12)
    assert nbytes == 4 * 8000 * D * 2 + 4 * 8000 + 2 * (4 * D * D + F * K * D + D * F) \
        + 4 * (9 * D + F)


def test_block_bound_counts_valid_rows_only():
    full = R.block_bound([1000, 1000], D, H, F, K)[2]
    part = R.block_bound([1000, 300], D, H, F, K)[2]
    row = lambda m: m * (8 * D * D + 4 * m * D + 2 * K * D * F + 2 * F * D)
    assert full - part == row(1000) - row(300)


@pytest.mark.parametrize("BH,T,fwd,bwd", [(10, 896, 4.11, 10.28), (160, 896, 65.77, 164.42)])
def test_flash_bound_at_the_smokes_shapes(BH, T, fwd, bwd):
    assert R.flash_bound([T] * BH, 128, "bfloat16", False)[2] / 1e9 == pytest.approx(fwd, abs=0.01)
    assert R.flash_bound([T] * BH, 128, "bfloat16", True)[2] / 1e9 == pytest.approx(bwd, abs=0.01)


def test_flash_bytes_at_t896():
    # PERF.md: 11.54 MB forward, 23.01 MB backward at BH=10, T=896, D=128
    assert R.flash_bound([896] * 10, 128, "bfloat16", False)[3] / 1e6 == pytest.approx(11.54, abs=0.01)
    assert R.flash_bound([896] * 10, 128, "bfloat16", True)[3] / 1e6 == pytest.approx(23.01, abs=0.01)


def test_melgan_flops_by_hand():
    # one frame: conv_in 80->512 k7, then per ratio r a transposed conv
    # (c -> c/2, k 2r: 4 c (c/2) a sample) and three blocks of a k3 and two
    # 1x1 convs at c/2, over 8, 64, 128, 256 samples; conv_out 32->1 k7
    want = 2 * 7 * 80 * 512
    c, n = 512, 1
    for r in (8, 8, 2, 2):
        n *= r
        want += n * 4 * c * (c // 2)
        c //= 2
        want += n * 3 * (6 * c * c + 4 * c * c)
    want += 256 * 2 * 7 * 32
    assert R.melgan_flops(1) == want
    assert R.melgan_flops(500) == 500 * want
    assert 85e6 < want < 95e6


def test_acoustic_flops_sum_of_parts():
    model = {"transformer": {"encoder_layer": 4, "decoder_layer": 6, "encoder_hidden": D,
                             "decoder_hidden": D, "conv_filter_size": F,
                             "conv_kernel_size": [K, 1]},
             "variance_predictor": {"filter_size": 256, "kernel_size": 3}}
    n, m = 74, 480
    enc = 4 * n * (8 * D * D + 4 * n * D + 2 * K * D * F + 2 * F * D)
    dec = 6 * m * (8 * D * D + 4 * m * D + 2 * K * D * F + 2 * F * D)
    va = 3 * n * (2 * 3 * D * 256 + 2 * 3 * 256 * 256 + 2 * 256)
    head = m * (2 * D * 80 + 2 * 5 * (80 * 512 + 3 * 512 * 512 + 512 * 80))
    assert R.acoustic_flops(n, m, model) == enc + dec + va + head
    assert R.baseline_ideal_s([n], [m], model) == pytest.approx(3 * (enc + dec + va + head) / 989e12)


class _Trace:
    def __init__(self, kernels, units):
        self.device = kernels
        self.units = units

    def time_in(self, pattern):
        return sum(e - s for n, s, e in self.device if pattern.search(n))


def test_shares_at_most_100_for_a_time_equal_to_the_bound():
    from perfbench import harness
    lens = [300, 500, 1000]
    src = [40, 70, 150]

    class Cell:
        pool = [[{"text": [0] * n, "mel": [0] * m} for n, m in zip(src, lens)]]

        records = [{"unit": 0}]

        def unit_lengths(self, rec):
            return src, lens

        def lengths(self, unit):
            return src, lens
    cfg = {"model": {"compute_dtype": "bfloat16", "transformer": {
        "encoder_layer": 4, "decoder_layer": 6, "encoder_hidden": D, "encoder_head": H,
        "conv_filter_size": F, "conv_kernel_size": [K, 1]}}}
    block = 4 * R.block_bound(src, D, H, F, K)[0] + 6 * R.block_bound(lens, D, H, F, K)[0]
    rows = lambda ls: [x for x in ls for _ in range(H)]
    flash = sum(n * (R.flash_bound(rows(ls), D // H, "bfloat16", False)[0]
                     + R.flash_bound(rows(ls), D // H, "bfloat16", True)[0])
                for ls, n in ((src, 4), (lens, 6)))
    for name, t in (("fftblock_roofline.serve", block), ("flash_roofline.base", flash)):
        kernel = "void gemm_kernel<1>" if "fftblock" in name else "fwd_bf16(x)"
        run = type("Run", (), {"trace": _Trace([(kernel, 0.0, t)], 1), "cell": Cell(),
                               "cfg": cfg})()
        assert harness.load_reader(name).read(run) == pytest.approx(100.0)
