"""The fused FFT block's share of its roofline in serving: the sum over the
traced requests' ten block calls of the least time (``roofline.block_bound``
over each call's valid rows: phonemes in the encoder, frames in the
decoder) over the device time of the block's kernels
(``csrc/fftblock.cu``) in the trace, in %."""

import re

from perfbench import roofline

KERNELS = re.compile(r"\b(gemm_kernel|attn_kernel|ln_rows_kernel|to_bf16_kernel)\b")


def read(run):
    t = run.trace
    device_s = t.time_in(KERNELS) if t is not None else 0.0
    if not device_s:
        return None
    tf = run.cfg["model"]["transformer"]
    D, H, F, K = (tf["encoder_hidden"], tf["encoder_head"], tf["conv_filter_size"],
                  tf["conv_kernel_size"][0])
    bound = 0.0
    for rec in run.cell.records[:t.units]:
        src, mel = run.cell.unit_lengths(rec)
        bound += tf["encoder_layer"] * roofline.block_bound(src, D, H, F, K)[0]
        bound += tf["decoder_layer"] * roofline.block_bound(mel, D, H, F, K)[0]
    return 100.0 * bound / device_s
