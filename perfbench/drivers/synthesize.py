"""Serving: request batches through ``SynthesisEngine.synthesize``.

A closed loop: one client sends the pool's requests back to back, the next
when the last has returned; a request ends with the wavs on the host, and
its latency runs from its own submit.  A forward hook on the engine's
acoustic model keeps what each request predicted (log-durations, pitch,
energy, the rounded durations), so that the reference can check the
served durations and follow the served decisions.  In a traced run, CUDA events around the acoustic model's
forward and around ``Vocoder.infer`` give the per-layer spans.
"""

import math
import sys
import time
import warnings

import numpy as np
import torch

from .. import roofline, traffic, weights as W
from ..reference import model as R
from . import common as C


def durations(out):
    """The reference's own frames a phoneme from its predicted
    log-durations: rounded half to even, clamped at 0, 0 past the text."""
    d = torch.clamp(torch.round(torch.exp(out.log_d_pred) - 1.0), min=0).long()
    return torch.where(out.src_valid, d, 0)


class Cell:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.records, self.outs = [], []
        self.spans = {"acoustic_ms": [], "vocoder_ms": []}

    # ------------------------------------------------------------ set-up

    def _weights(self, model, vocoder_net):
        cfg, dev = self.cfg, self.device
        wa = C.acoustic_weights(model, self.seed, dev)
        # random weights predict ~0 frames a phoneme: the duration
        # predictor's output layer is drawn small around a bias of
        # log(1 + frames a phoneme), so that every phoneme takes the mix's
        # frames (the predicted log-durations stay within ~0.01 of the bias,
        # far from a rounding edge) and the served lengths are the
        # traffic's, the same for every seed
        dp = "variance_adaptor.duration_predictor.linear_layer."
        wa[dp + "weight"] *= cfg["weights"]["duration_weight_scale"]
        wa[dp + "bias"].fill_(math.log(1.0 + self.mix["frames_per_phoneme"]))
        # MelGAN: the port's init scale, the biases drawn at a fraction of
        # it (at full scale they swamp the signal with a constant offset;
        # a vocoder that dropped its bias adds would still show), and the
        # output convolution scaled so that the reference's waveform of the
        # first request has the configured RMS before the tanh: random
        # weights otherwise give near silence, which int16 rounds to a few
        # counts
        gain = cfg["weights"]["vocoder_gain"]
        wv = W.make(dict(vocoder_net.named_parameters()), C.weight_seed(self.seed, "vocoder"), dev,
                    gain=gain)
        for n in wv:
            if n.endswith(".bias"):
                wv[n] *= cfg["weights"]["vocoder_bias_scale"] / gain

        def level():
            b = C.pad(self.pool[0], dev)
            first = R.fastspeech2(wa, cfg, cfg["stats"], b, train=False,
                                  durations=torch.ones_like(b["texts"]),
                                  p_bins_from=torch.zeros(b["texts"].shape, device=dev),
                                  e_bins_from=torch.zeros(b["texts"].shape, device=dev),
                                  n_frames=8)
            out = R.fastspeech2(wa, cfg, cfg["stats"], b, train=False,
                                durations=durations(first),
                                p_bins_from=first.p_pred, e_bins_from=first.e_pred,
                                n_frames=self.mix["mel_cap"])
            x = R.melgan(wv, out.postnet_mel, pre_tanh=True)
            keep = R.lengths_mask(out.mel_lens * self.hop, x.shape[1])
            return float(x[keep].pow(2).mean().sqrt())
        with torch.no_grad():
            wv["conv_out.weight"] *= cfg["weights"]["vocoder_rms"] / C.with_tf32_off(level)
        return wa, wv

    def setup(self):
        from metatts_torch.models.fastspeech2 import FastSpeech2
        from metatts_torch.models.vocoder import Vocoder
        from metatts_torch.serve import SynthesisEngine
        cfg = self.cfg
        pp = cfg["preprocess"]["preprocessing"]
        self.hop, self.sr = pp["stft"]["hop_length"], pp["audio"]["sampling_rate"]
        self.pool, _ = traffic.draw(self.mix, cfg, self.seed)
        model = FastSpeech2(cfg["preprocess"], cfg["model"], cfg["algorithm"], cfg["stats"],
                            cfg["n_speakers"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            vocoder = Vocoder(cfg["model"], n_mels=pp["mel"]["n_mel_channels"],
                              device=self.device)
        self.wa, self.wv = self._weights(model, vocoder.net)
        W.load_into(model, self.wa)
        W.load_into(vocoder.net, self.wv)
        self.engine = SynthesisEngine(model, cfg["preprocess"], cfg["model"], cfg["algorithm"],
                                      vocoder=vocoder, device=self.device)
        self.engine.model.register_forward_hook(self._keep)
        if getattr(self, "fault", None):
            self.fault(self)
        self.vocoder_peak = (roofline.PEAK_TF32 if torch.backends.cudnn.allow_tf32
                             else roofline.PEAK_FP32)
        # warm up every text bucket the pool sends (the decoder always runs
        # at the cap)
        seen = set()
        for i, unit in enumerate(self.pool):
            b = C.bucket(max(len(s["text"]) for s in unit), C.TEXT_BUCKET)
            if b not in seen:
                seen.add(b)
                self._request(i)
        self.outs.clear()
        self.next = 0

    def _keep(self, module, args, out):
        self.outs.append((out.log_d_pred, out.p_pred, out.e_pred, out.d_rounded))

    def _request(self, i):
        unit = self.pool[i]
        return self.engine.synthesize([s["text"] for s in unit],
                                      speakers=[s["speaker"] for s in unit],
                                      mel_cap=self.mix["mel_cap"])

    # ------------------------------------------------------------ window

    def trace_spans(self):
        """CUDA events around the acoustic model's forward and the
        vocoder's ``infer`` (the copy of the wavs to the host included)."""
        self._ev = {"acoustic_ms": [], "vocoder_ms": []}
        model, voc = self.engine.model, self.engine.vocoder
        stamp = lambda: C.Stamp(self.device)

        def pre(module, args):
            self._ev["acoustic_ms"].append([stamp(), None])

        def post(module, args, out):
            self._ev["acoustic_ms"][-1][1] = stamp()
        model.register_forward_pre_hook(pre)
        model.register_forward_hook(post)
        infer = voc.infer

        def timed_infer(*a, **k):
            start = stamp()
            out = infer(*a, **k)
            self._ev["vocoder_ms"].append([start, stamp()])
            return out
        voc.infer = timed_infer

    def run_window(self, seconds, tracer=None):
        rng = traffic.rng_for(self.seed, "sample")
        self.sample, offer = C.reservoir(rng, self.mix["check_requests"])
        self.longest = None
        self.outs.clear()
        self.attempted = self.failed = 0
        t0 = time.perf_counter()
        while True:
            i = self.next % len(self.pool)
            self.next += 1
            self.attempted += 1
            ts = time.perf_counter()
            try:
                with torch.profiler.record_function("perfbench.request"):
                    got = self._request(i)
            except Exception as exc:            # counted, and the run is not correct
                self.failed += 1
                print(f"perfbench: a request failed: {exc!r}", file=sys.stderr)
                got = None
            te = time.perf_counter()
            if got is not None:
                audio = sum(len(w) for w, _ in got) / self.sr
                rec = {"unit": i, "ms": 1e3 * (te - ts), "audio_s": audio,
                       "hook": len(self.outs) - 1, "out": got}
                self.records.append(rec)
                left = offer(rec)
                if self.longest is None or audio > self.longest["audio_s"]:
                    left2, self.longest = self.longest, rec
                    if left2 is not None and all(left2 is not s for s in self.sample):
                        left2["out"] = None
                # keep the outputs of the sample and of the longest only
                if left is not None and left is not self.longest:
                    left["out"] = None
            if tracer is not None:
                tracer.unit_done()
            if te - t0 >= seconds:
                break
        self.window_end = time.perf_counter()
        self.window_s = self.window_end - t0
        if hasattr(self, "_ev"):
            for k, pairs in self._ev.items():
                self.spans[k] = [a.ms_to(b) for a, b in pairs]

    def end_to_end(self):
        """The audio of every completed request over the window, and the
        95th percentile of every completed request's latency."""
        if not self.records:
            return {}
        return {"audio_s_per_s": sum(r["audio_s"] for r in self.records) / self.window_s,
                "request_p95_ms": float(np.percentile([r["ms"] for r in self.records], 95))}

    def unit_lengths(self, rec):
        """(src_lens, mel_lens) of a served request, from its hooked
        predictions."""
        _, _, _, d = self.outs[rec["hook"]]
        unit = self.pool[rec["unit"]]
        src = [len(s["text"]) for s in unit]
        mel = np.minimum(d.sum(-1).cpu().numpy(), self.mix["mel_cap"]).tolist()
        return src, mel

    def ideal_s(self, records):
        """The requests' operations at their peaks, summed."""
        return sum(roofline.serve_ideal_s(*self.unit_lengths(r), self.cfg["model"],
                                          self.vocoder_peak) for r in records)

    def free(self):
        del self.engine
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def check(self):
        """The readings of the comparison with the reference, over the
        sampled requests and the longest."""
        checked = list(self.sample)
        if self.longest is not None and all(self.longest is not s for s in checked):
            checked.append(self.longest)
        items = [(r["unit"], (self.outs[r["hook"]], r["out"])) for r in checked]
        return C.with_tf32_off(lambda: compare(self, items))


def compare(cell, items):
    """Each item: (pool index, ((log_d, p, e, durations), [(wav, mel)])).
    The served durations must be the reference's own rounding of its
    log-durations, exactly (``length_mismatch`` counts every phoneme,
    mel and wav whose length differs); past that the reference follows the
    served durations and bins; its wavs come from the served mels (the
    padded frames past each mel, which the vocoder also reads, are the
    reference's)."""
    cfg, dev, cap = cell.cfg, cell.device, cell.mix["mel_cap"]
    worst = {"length_mismatch": 0.0, "log_d_gap": 0.0, "pitch_gap": 0.0, "energy_gap": 0.0,
             "mel_gap": 0.0, "wav_gap": 0.0}
    for i, ((log_d, p, e, d), pairs) in items:
        unit = cell.pool[i]
        if log_d.shape[0] != len(unit) or len(pairs) != len(unit):
            worst["length_mismatch"] += len(unit)       # answers missing or not its own
            continue
        L = log_d.shape[1]
        b = C.pad(unit, dev, L=L)
        with torch.no_grad():
            ref = R.fastspeech2(cell.wa, cfg, cfg["stats"], b, train=False, durations=d.to(dev),
                                p_bins_from=p.to(dev), e_bins_from=e.to(dev), n_frames=cap)
            valid = ref.src_valid
            worst["length_mismatch"] += float((d.to(dev).long() != durations(ref)).sum())
            for key, got, want in (("log_d_gap", log_d, ref.log_d_pred),
                                   ("pitch_gap", p, ref.p_pred), ("energy_gap", e, ref.e_pred)):
                worst[key] = max(worst[key], float((got.to(dev).float() - want)[valid].abs().max()))
            mel_in = ref.postnet_mel.clone()
            lens = ref.mel_lens.tolist()
            for j, (wav, mel) in enumerate(pairs):
                if len(mel) != lens[j] or len(wav) != lens[j] * cell.hop:
                    worst["length_mismatch"] += 1
                    continue
                m = torch.from_numpy(np.asarray(mel)).to(dev)
                want = ref.postnet_mel[j, :lens[j]]
                if lens[j]:
                    worst["mel_gap"] = max(worst["mel_gap"], float(
                        (m - want).abs().max() / want.abs().max().clamp_min(1e-6)))
                mel_in[j, :lens[j]] = m
            wav_ref = R.melgan(cell.wv, mel_in) * 32768.0
            for j, (wav, mel) in enumerate(pairs):
                n = lens[j] * cell.hop
                if len(wav) != n or n == 0:
                    continue
                w = torch.from_numpy(np.asarray(wav).astype(np.float32)).to(dev)
                want = wav_ref[j, :n]
                worst["wav_gap"] = max(worst["wav_gap"], float(
                    (w - want).abs().max() / want.abs().max().clamp_min(1.0)))
    return worst


def control_served(cell, i, bits=("fp8", "bfloat16")):
    """The reference put in the program's place at the precisions below the
    configuration's (the acoustic model's products in fp8, the vocoder's in
    bf16): its own durations and bins, mels and int16 wavs."""
    cfg, dev, cap = cell.cfg, cell.device, cell.mix["mel_cap"]
    q = R.Precision(R.BITS[bits[0]], R.BITS[bits[1]])
    unit = cell.pool[i]
    b = C.pad(unit, dev)
    with torch.no_grad():
        # the prediction pass: durations and bins are decided from it
        first = R.fastspeech2(cell.wa, cfg, cfg["stats"], b, q=q.a, train=False,
                              durations=torch.ones_like(b["texts"]),
                              p_bins_from=torch.zeros(b["texts"].shape, device=dev),
                              e_bins_from=torch.zeros(b["texts"].shape, device=dev), n_frames=8)
        d = durations(first)
        out = R.fastspeech2(cell.wa, cfg, cfg["stats"], b, q=q.a, train=False, durations=d,
                            p_bins_from=first.p_pred, e_bins_from=first.e_pred, n_frames=cap)
        wav = (R.melgan(cell.wv, out.postnet_mel, q.v) * 32768.0).cpu().numpy().astype(np.int16)
        lens = out.mel_lens.tolist()
        pairs = [(wav[j, :lens[j] * cell.hop], out.postnet_mel[j, :lens[j]].cpu().numpy())
                 for j in range(len(unit))]
    return (first.log_d_pred, first.p_pred, first.e_pred, d), pairs
