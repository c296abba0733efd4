"""The yardstick's arithmetic: the card's peaks, the least time of a fused
FFT-block call and of a flash-attention call (frozen from ``chip_smoke.py``'s
``block_bound`` and ``flash_bound``, here over each row's valid length),
and the operations a request or a training step needs, counted from its
shapes over valid phonemes and frames only.

Peaks: one NVIDIA H100 SXM, dense, NVIDIA's data sheet: 989 TFLOP/s bf16,
495 TFLOP/s TF32, 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s.
"""

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
MELGAN = dict(ngf=32, ratios=(8, 8, 2, 2), dilations=(1, 3, 9), n_mels=80)


def _bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def block_bound(lens, D, H, F, K):
    """(seconds, bound_by, flops, bytes) of one fused FFT-block call over
    rows of valid lengths ``lens``: each valid input read once, each valid
    output written once.  With every length equal to the padded T it is
    ``chip_smoke.py``'s ``block_bound`` (in seconds)."""
    n = sum(lens)
    flops = sum(m * (2 * D * 3 * D + 4 * m * D + 2 * D * D + 2 * K * D * F + 2 * F * D)
                for m in lens)
    weights = 2 * (3 * D * D + D * D + F * K * D + D * F)
    vectors = 4 * (3 * D + D + 2 * D + F + D + 2 * D)
    nbytes = 4 * n * D * 2 + 4 * n + weights + vectors
    return _bound(flops, nbytes, PEAK_BF16)


def flash_bound(lens, D, dtype, backward):
    """(seconds, bound_by, flops, bytes) of one flash call over (batch x
    head) rows of valid lengths ``lens``: valid queries against valid keys,
    each input read once, each output written once.  Forward: q k^T and
    P v; backward: q k^T, dv, dp, dq, dk (the recomputed P included)."""
    e = 2 if dtype == "bfloat16" else 4
    flops = (10 if backward else 4) * D * sum(m * m for m in lens)
    n = sum(lens)
    if backward:   # q, k, v, mask, out, lse, dout in; dq, dk, dv out
        nbytes = 3 * n * D * e + 4 * n + 4 * n * D + 4 * n + 4 * n * D + 3 * n * D * e
    else:          # q, k, v, mask in; out, lse out
        nbytes = 3 * n * D * e + 4 * n + 4 * n * D + 4 * n
    return _bound(flops, nbytes, PEAK_BF16 if dtype == "bfloat16" else PEAK_FP32)


# ------------------------------------------------------ operations needed

def _fft_layer(m, D, F, K):
    return m * (8 * D * D + 4 * m * D + 2 * K * D * F + 2 * F * D)


def encoder_flops(n, t):
    return t["encoder_layer"] * _fft_layer(n, t["encoder_hidden"], t["conv_filter_size"],
                                           t["conv_kernel_size"][0])


def variance_flops(n, model):
    """Three predictors (two k-conv layers and a linear each) over ``n``
    phonemes."""
    D = model["transformer"]["encoder_hidden"]
    v = model["variance_predictor"]
    f, k = v["filter_size"], v["kernel_size"]
    return 3 * n * (2 * k * D * f + 2 * k * f * f + 2 * f)


def decoder_flops(m, t):
    return t["decoder_layer"] * _fft_layer(m, t["decoder_hidden"], t["conv_filter_size"],
                                           t["conv_kernel_size"][0])


def head_flops(m, t, n_mels=80, post=512, k=5):
    """mel_linear and the postnet's five convolutions over ``m`` frames."""
    convs = n_mels * post + 3 * post * post + post * n_mels
    return m * (2 * t["decoder_hidden"] * n_mels + 2 * k * convs)


def acoustic_flops(n, m, model):
    """One utterance's forward: ``n`` phonemes, ``m`` frames."""
    t = model["transformer"]
    return encoder_flops(n, t) + variance_flops(n, model) + decoder_flops(m, t) + head_flops(m, t)


def melgan_flops(frames, ngf=MELGAN["ngf"], ratios=MELGAN["ratios"], n_mels=MELGAN["n_mels"],
                 dilations=MELGAN["dilations"]):
    """MelGAN's generator over ``frames`` mel frames: conv_in (k 7), per
    upsampling a transposed conv (k 2r, stride r) and three residual blocks
    (a k-3 conv and two 1x1), conv_out (k 7)."""
    c = ngf * 2 ** len(ratios)
    samples = frames
    flops = samples * 2 * 7 * n_mels * c
    for r in ratios:
        samples *= r
        flops += samples * 2 * c * (c // 2) * 2
        c //= 2
        flops += samples * len(dilations) * (2 * 3 * c * c + 2 * c * c + 2 * c * c)
    return flops + samples * 2 * 7 * c


def serve_ideal_s(src_lens, mel_lens, model, vocoder_peak):
    """A request's operations at their peaks: the acoustic model in bf16,
    the vocoder at ``vocoder_peak``, over valid phonemes and frames."""
    ac = sum(acoustic_flops(n, m, model) for n, m in zip(src_lens, mel_lens))
    return ac / PEAK_BF16 + melgan_flops(sum(mel_lens)) / vocoder_peak


def baseline_ideal_s(src_lens, mel_lens, model):
    """A baseline step: forward and backward (twice the forward) of every
    utterance, in bf16."""
    return 3 * sum(acoustic_flops(n, m, model) for n, m in zip(src_lens, mel_lens)) / PEAK_BF16
