"""The flash-attention kernels' share of their roofline in a step: the sum
over the traced steps' calls, forward and backward, of the least time
(``roofline.flash_bound`` over valid queries and keys of every utterance
and head) over the device time of the flash kernels
(``csrc/flash_attention.cu``) in the trace, in %.  The cell's
``lengths(unit)`` gives the (phonemes, frames) of the utterances that its
step runs through flash."""

import re

from perfbench import roofline

KERNELS = re.compile(r"\b(fwd_bf16|bwd_prep_bf16|bwd_bf16|bwd_delta|fwd_f32|bwd_dq_f32|bwd_dkdv_f32)\b")


def read(run):
    t = run.trace
    device_s = t.time_in(KERNELS) if t is not None else 0.0
    if not device_s:
        return None
    tf = run.cfg["model"]["transformer"]
    H, D = tf["encoder_head"], tf["encoder_hidden"] // tf["encoder_head"]
    dtype = run.cfg["model"]["compute_dtype"]
    bound = 0.0
    for rec in run.cell.records[:t.units]:
        src, mel = run.cell.lengths(run.cell.pool[rec["unit"]])
        for lens, layers in ((src, tf["encoder_layer"]), (mel, tf["decoder_layer"])):
            rows = [n for n in lens for _ in range(H)]
            bound += layers * (roofline.flash_bound(rows, D, dtype, False)[0]
                               + roofline.flash_bound(rows, D, dtype, True)[0])
    return 100.0 * bound / device_s
