"""The test stage's loop (the JAX package's ``train/loop.py``: ``Trainer``
with its ``test`` and ``_save_test_audio``).

For every frozen test task: adapt on the support set with saving-step
snapshots (``System.test_adapt_tasks``, or ``test_adapt_batched`` over
``test_task_batch`` tasks at once), write the task's CSV of query losses
and, with a vocoder, one teacher-forced ``recon`` wav from the un-adapted
weights and one ``step_<ckpt>-FTstep_<n>.synth`` wav with its figure per
saving step.  Training runs (``fit``) wait for ROADMAP Queue 1 item 6.
"""

import os

import torch

from ..algorithms.adapt import episode_speaker_args
from ..algorithms.base import episode
from ..data.collate import collate_episode
from ..models.loss import LossValues
from .logging import ExperimentLogger
from .saver import Saver


class Trainer:
    def __init__(self, system, datamodule, train_cfg, output_dir="output",
                 exp_name="exp", vocoder=None):
        self.system = system
        self.dm = datamodule
        self.tcfg = train_cfg
        self.output_dir = output_dir
        self.exp_name = exp_name
        self.ckpt_dir = os.path.join(output_dir, "ckpt", exp_name)
        self.saver = Saver(
            log_dir=os.path.join(output_dir, "log", exp_name),
            result_dir=os.path.join(output_dir, "result", exp_name))
        self.logger = ExperimentLogger(self.saver.log_dir, exp_name)
        self.vocoder = vocoder

    def fit(self, resume_from=None, max_steps=None):
        raise NotImplementedError(
            "training runs (Trainer.fit, the training loaders, the prefetcher) "
            "are not ported yet: ROADMAP Queue 1 item 6")

    # -------------------------------------------------------------- test

    def test(self, ckpt_step="last", max_tasks=None, tasks_per_label=None,
             task_batch=None):
        """Few-shot test: adapt on support, synthesize query, save artifacts
        (reference ``base_adaptor.py:136-189`` + Saver test tree).
        ``tasks_per_label`` overrides the per-speaker task count (reference
        default 16).  ``task_batch`` (or ``train.test_task_batch``) runs that
        many tasks through one ``System.test_adapt_batched`` call; "auto" is
        1, since every task runs on the system's one device, and 1-shot mode
        keeps the sequential path.  Returns task id -> rows."""
        system = self.system
        test_cfg = system.acfg["adapt"]["test"]
        tb = task_batch or self.tcfg.get("test_task_batch", 1)
        if tb == "auto" or test_cfg.get("1-shot", False):
            tb = 1
        if test_cfg.get("avg_train_spk_emb") and system.model.speaker_emb is not None \
                and system.model.speaker_emb.emb_type == "table":
            # overwrite unseen-speaker rows with the mean train embedding
            # (reference on_test_start, system.py:195-213)
            from .checkpoint import average_speaker_rows
            train_rows = sorted({self.dm.train_set[i]["speaker"]
                                 for i in range(len(self.dm.train_set))})
            average_speaker_rows(system.model, train_rows)
            print(f"[test] avg_train_spk_emb over {len(train_rows)} rows")
        results = {}
        episodes = (self.dm.test_episodes(tasks_per_label)
                    if tasks_per_label else self.dm.test_episodes())

        def finish(tid, rows, snapshots, sup, qry, qry_meta):
            self.saver.log_task_csv("Testing", tid, rows, ckpt_step=ckpt_step)
            if self.vocoder is not None:
                self._save_test_audio(tid, snapshots, sup, qry, qry_meta, ckpt_step)
            results[tid] = rows

        def run_sequential(i, sup, qry):
            sup_b, qry_b, _, qry_meta = collate_episode([sup], [qry])
            sup_e, qry_e = episode(sup_b, 0), episode(qry_b, 0)
            # 1-shot mode yields one trajectory per support utterance
            # (suffix _<k>); the standard mode one ("", ...)
            for suffix, rows, snapshots in system.test_adapt_tasks(sup_e, qry_e):
                finish(f"test_{i:03d}{suffix}", rows, snapshots, sup_e, qry_e,
                       qry_meta[0])

        def run_batched(buf):
            sup_b, qry_b, _, qry_meta = collate_episode(
                [b[1] for b in buf], [b[2] for b in buf])
            rows_E, snaps_E = system.test_adapt_batched(sup_b, qry_b)
            for e, (i, _, _) in enumerate(buf):
                rows = [(ft, LossValues(*(float(v[e]) for v in vals)))
                        for ft, vals in rows_E]
                snapshots = [(ft, {k: v[e] for k, v in snap.items()})
                             for ft, snap in snaps_E]
                finish(f"test_{i:03d}", rows, snapshots, episode(sup_b, e),
                       episode(qry_b, e), qry_meta[e])

        buf = []
        for i, (_, (sup, qry)) in enumerate(episodes):
            if max_tasks and i >= max_tasks:
                break
            if tb <= 1:
                run_sequential(i, sup, qry)
                continue
            buf.append((i, sup, qry))
            if len(buf) == tb:
                run_batched(buf)
                buf = []
        if buf:
            # the remainder: a smaller batch, or the sequential path for one
            if len(buf) == 1:
                run_sequential(*buf[0])
            else:
                run_batched(buf)
        return results

    @torch.no_grad()
    def _save_test_audio(self, task_id, snapshots, sup, qry, qry_meta,
                         ckpt_step):
        """Per-task test audio at every saving step (reference Saver test
        tree, ``saver.py:130-194``): ``*.recon.wav`` teacher-forced from the
        un-adapted (step 0) weights, and ``*.step_<ckpt>-FTstep_<n>.synth.wav``
        fully predicted from each snapshot, each with its spectrogram and
        pitch/energy figure; every forward on the fused FFT blocks."""
        from .synth_utils import prepare_tracks
        system = self.system
        dev = system.device
        hop = system.pcfg["preprocessing"]["stft"]["hop_length"]
        sup, qry = sup.to(dev), qry.to(dev)
        qry_c = qry._replace(speaker_args=episode_speaker_args(
            sup.speaker_args, qry.speaker_args))

        def vocode_and_save(params, tag, teacher):
            params = {k: v.to(dev) for k, v in params.items()}
            out = system.adaptor.forward(params, qry_c, train=False,
                                         teacher_forced=teacher,
                                         average_spk_emb=True, fused_infer=True)
            mel_lens = out.mel_lens.cpu().numpy()
            wavs = self.vocoder.infer(out.postnet_mel, lengths=mel_lens * hop)
            for j, w in enumerate(wavs):
                if len(w) == 0:
                    continue
                name = f"{qry_meta.ids[j]}.{tag}"
                path = self.saver.save_audio("Testing", task_id, name, w,
                                             ckpt_step=ckpt_step)
                self.logger.log_artifact(0, "audio", path)
                mel, pitch, energy = prepare_tracks(out, system.stats, system.pcfg,
                                                    index=j)
                fig = self.saver.save_track_figure(
                    "Testing", task_id, name, mel, pitch, energy,
                    ckpt_step=ckpt_step)
                self.logger.log_artifact(0, "figure", fig)

        # teacher-forced reconstruction once, from the un-adapted weights
        # (reference recon_samples at ft_step == 0, saver.py:158-165)
        vocode_and_save(snapshots[0][1], "recon", teacher=True)
        for ft_step, params in snapshots:
            vocode_and_save(params, f"step_{ckpt_step}-FTstep_{ft_step}.synth",
                            teacher=False)
