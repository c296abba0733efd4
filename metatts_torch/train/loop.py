"""Training and test loops (the JAX package's ``train/loop.py``: ``Trainer``
with ``fit``, ``validate``, ``test`` and the in-loop synthesis).

``fit`` runs the system's training step on the datamodule's batches
(episodes for the meta system) with the JAX package's cadences: a log line
and the train CSV every ``log_step``, episodic validation every
``val_step``, a synthesized training sample every ``synth_step`` and
``step_<n>.ckpt`` + ``last.ckpt`` every ``save_step`` and at the end.
``test`` adapts on every frozen test task with saving-step snapshots
(``System.test_adapt_tasks``, or ``test_adapt_batched`` over
``test_task_batch`` tasks at once) and writes the task's CSV of query
losses and, with a vocoder, one teacher-forced ``recon`` wav from the
un-adapted weights and one ``step_<ckpt>-FTstep_<n>.synth`` wav with its
figure per saving step.

Under a launcher with ``WORLD_SIZE`` > 1 (``torchrun``), ``fit`` and
``test`` join the process group and call ``System.enable_distributed``
unless ``train.distributed`` is "off": every rank draws the same global
batches and computes its shard, and only rank 0 writes logs, CSVs,
checkpoints and audio.
"""

import os
import time

import numpy as np
import torch

from ..algorithms.adapt import episode_speaker_args
from ..algorithms.base import episode
from ..data.collate import collate_episode, map_batch
from ..models.loss import LossValues
from ..parallel import distributed as D
from .checkpoint import load_checkpoint, save_checkpoint
from .logging import ExperimentLogger
from .saver import Saver


class Trainer:
    def __init__(self, system, datamodule, train_cfg, output_dir="output",
                 exp_name="exp", vocoder=None):
        self.system = system
        self.dm = datamodule
        self.tcfg = train_cfg
        self.steps = train_cfg["step"]
        self.output_dir = output_dir
        self.exp_name = exp_name
        self.ckpt_dir = os.path.join(output_dir, "ckpt", exp_name)
        self.saver = Saver(
            log_dir=os.path.join(output_dir, "log", exp_name),
            result_dir=os.path.join(output_dir, "result", exp_name))
        self.logger = ExperimentLogger(self.saver.log_dir, exp_name)
        self.vocoder = vocoder

    def _distribute(self):
        """Under a launcher with ``WORLD_SIZE`` > 1, join its process group
        and shard the system over it (``System.enable_distributed``) unless
        ``train.distributed`` is "off"; the system must already sit on the
        rank's device (``parallel.distributed.init_from_env`` returns it).
        Returns True where this process writes the run's files (rank 0, or
        no process group)."""
        system = self.system
        if (self.tcfg.get("distributed", "auto") != "off" and system.shard is None
                and D.init_from_env(device=system.device) is not None):
            shard = system.enable_distributed()
            if shard is not None and D.is_main():
                print(f"[ddp] {shard.world} ranks over {D.dist.get_backend()}; the "
                      f"{'episode' if system.algorithm_type != 'baseline' else 'batch'} "
                      "axis sharded, weights replicated")
        return D.is_main()

    def _task_batch(self, task_batch):
        """``task_batch`` or ``train.test_task_batch``; "auto" is the world
        size (1 without a process group)."""
        tb = task_batch or self.tcfg.get("test_task_batch", 1)
        return (self.system.shard.world if self.system.shard else 1) if tb == "auto" else tb

    # ------------------------------------------------------------- train

    def fit(self, resume_from=None, max_steps=None):
        """Train to ``max_steps`` (default ``step.total_step``), resuming
        from a checkpoint of either package: its weights, its step and,
        where surgery changed nothing, its optimizer state.

        Under a launcher every rank runs ``fit`` on its shard (the module
        docstring); rank 0 alone logs, validates into CSVs, synthesizes and
        saves.  Left out against the JAX package: ``train.transfer_mel_dtype``,
        TPU transfer plumbing, which is read and ignored.  Failures of the in-loop synthesis and of
        the validation sample are not caught, where the JAX package prints
        them and goes on: a kernel fault on the card must not hide behind a
        run that goes on.  ``train.profile``: "simple" (default) times every
        step and prints the ``[profile]`` line at the end, "trace" also
        writes a ``torch.profiler`` trace of steps 4-8 under
        ``<log_dir>/profile``, "off" neither."""
        from ..data.prefetch import Prefetcher
        from ..utils.profiling import StepTimer, device_memory_stats, trace
        system = self.system
        total = max_steps or self.steps["total_step"]
        log_every = self.steps["log_step"]
        val_every = self.steps["val_step"]
        save_every = self.steps["save_step"]
        synth_every = self.steps.get("synth_step", 0)
        main = self._distribute()

        if main:
            self.logger.log_hyperparams({
                "model": system.mcfg, "train": self.tcfg, "algorithm": system.acfg})
        if resume_from:
            opt_state, step, report = load_checkpoint(resume_from, system.model)
            if opt_state is not None:
                system.optimizer.load_state_tree(opt_state, system.model)
            system.global_step = step
            for r in report:
                print(f"[ckpt surgery] {r}")

        meta = system.algorithm_type in ("meta", "imaml")
        if meta:
            gen = self.dm.train_episode_batches(
                system.acfg["adapt"]["train"]["meta_batch_size"])
        else:
            gen = self.dm.train_batches(self.tcfg["optimizer"]["batch_size"])
        gen = Prefetcher(gen, depth=2)   # collation behind the card's work

        prof_mode = self.tcfg.get("profile", "simple")
        timer = StepTimer() if prof_mode != "off" else None
        trace_cm = None
        t0 = time.time()
        t_warm = warm_step = None   # wall clock after the first step
        try:
            while system.global_step < total:
                if prof_mode == "trace" and system.global_step == 3 and trace_cm is None:
                    trace_cm = trace(os.path.join(self.saver.log_dir, "profile"))
                    trace_cm.__enter__()
                if timer:
                    timer.__enter__()
                if meta:
                    item = next(gen)
                    sup, qry = item[:2]
                    # cross-lingual episodes carry their phoneme representations
                    losses = (system.train_step(sup, qry) if len(item) < 5
                              else system.train_step(sup, qry, phn_ref=item[4]))
                else:
                    batch, _ = next(gen)
                    losses = system.train_step(batch)
                step = system.global_step
                if timer:
                    float(losses.total)   # wait for the card, so the wall is real
                    timer.__exit__()
                if t_warm is None:
                    t_warm, warm_step = time.time(), step
                if trace_cm is not None and step >= 8:
                    trace_cm.__exit__(None, None, None)
                    trace_cm = None
                    prof_mode = "simple"
                if main and (step % log_every == 0 or step == total):
                    self._log_step(step, total, losses, t0, timer)
                if step % val_every == 0 and hasattr(self.dm, "val_episodes"):
                    self.validate(step)
                if (main and self.vocoder is not None and synth_every
                        and step % synth_every == 0):
                    self.synth_sample(step, sup if meta else batch, episode_batched=meta)
                if main and (step % save_every == 0 or step == total):
                    for name in (f"step_{step}.ckpt", "last.ckpt"):
                        save_checkpoint(os.path.join(self.ckpt_dir, name), system.model,
                                        step, system.optimizer)
        finally:
            gen.close()
            if trace_cm is not None:
                trace_cm.__exit__(None, None, None)
        if main and timer and timer.stats():
            self._log_profile(timer.stats(), device_memory_stats(), t_warm, warm_step)
        return system

    def _log_step(self, step, total, losses, t0, timer):
        self.saver.log_train(step, losses)
        self.logger.log_metrics(step, losses.to_dict("train/"))
        rate = step / max(time.time() - t0, 1e-9)
        prof = ""
        if timer and timer.stats():
            s = timer.stats()
            prof = f" step {s['mean_ms']:.0f}ms p95 {s['p95_ms']:.0f}ms"
            self.logger.log_metrics(step, {"profile/step_mean_ms": s["mean_ms"],
                                           "profile/step_p95_ms": s["p95_ms"]})
        print(f"step {step}/{total} total={float(losses.total):.4f} "
              f"mel={float(losses.mel):.4f} ({rate:.2f} it/s{prof})")

    def _log_profile(self, s, mem, t_warm, warm_step):
        """The ``[profile]`` line: the StepTimer's stats (the step alone),
        the steps/s after the first step with validation, synthesis and
        checkpoints included, and the peak device memory."""
        step = self.system.global_step
        peak = max((m.get("peak_bytes_in_use") or 0 for m in mem.values()), default=0)
        e2e = ""
        if t_warm is not None and step > warm_step:
            e2e_rate = (step - warm_step) / max(time.time() - t_warm, 1e-9)
            e2e = f", e2e {e2e_rate:.2f} it/s incl val/ckpt"
            self.logger.log_metrics(step, {"profile/e2e_steps_per_sec": e2e_rate})
        print(f"[profile] {s['steps']} steps: mean {s['mean_ms']:.1f}ms "
              f"p50 {s['p50_ms']:.1f}ms p95 {s['p95_ms']:.1f}ms "
              f"({s['steps_per_sec']:.2f} it/s{e2e})"
              + (f"; peak device memory {peak / 2**30:.2f} GiB" if peak else ""))
        self.logger.log_metrics(step, {
            "profile/final_mean_ms": s["mean_ms"],
            "profile/final_p95_ms": s["p95_ms"],
            **({"profile/peak_hbm_bytes": peak} if peak else {})})

    # ---------------------------------------------------------- validate

    def validate(self, step, max_tasks=None, task_batch=None):
        """Episodic validation: every frozen val task, ``task_batch``
        (default ``train.test_task_batch``; "auto" is the world size, 1
        without a process group) at a time through
        ``System.validation_step_batched``, one task through
        ``validation_step``; one CSV row per task, and with a vocoder the
        first task's sample (``_save_val_sample``), on rank 0.  Returns the
        rows."""
        tb = self._task_batch(task_batch)
        main = D.is_main()
        totals, first_pair = [], []

        def run_batched(buf):
            sup_b, qry_b, _, _ = collate_episode([b[1] for b in buf], [b[2] for b in buf])
            if not first_pair:
                first_pair.append((episode(sup_b, 0), episode(qry_b, 0)))
            if len(buf) == 1:
                rows = [[float(x) for x in self.system.validation_step(
                    episode(sup_b, 0), episode(qry_b, 0))]]
            else:
                losses_E = self.system.validation_step_batched(sup_b, qry_b)
                rows = [[float(x[e]) for x in losses_E] for e in range(len(buf))]
            for (i, _, _), row in zip(buf, rows):
                totals.append(row)
                if main:
                    self.saver.log_task_csv("Validation", f"val_{i:03d}",
                                            [(step, LossValues(*row))])

        buf = []
        for i, (_, (sup, qry)) in enumerate(self.dm.val_episodes()):
            if max_tasks and i >= max_tasks:
                break
            buf.append((i, sup, qry))
            if len(buf) == max(1, int(tb)):
                run_batched(buf)
                buf = []
        if buf:
            run_batched(buf)
        if main and first_pair and self.vocoder is not None:
            # the first task's audio and synthesized-vs-ground-truth figure
            # (reference Saver on_validation_batch_end, saver.py:96-105)
            self._save_val_sample(step, *first_pair[0])
        if main and totals:
            mean = np.mean(totals, axis=0)
            print(f"[val @ {step}] total={mean[0]:.4f} mel={mean[1]:.4f}")
        return totals

    @torch.no_grad()
    def _save_val_sample(self, step, sup, qry):
        """Adapt on the support set as the val step does (first order, the
        train task's steps and lr, no dropout), run a teacher-forced query
        forward, and write the reconstruction and prediction wavs and a
        two-panel synthesized vs ground-truth spectrogram with the target
        pitch/energy tracks (reference ``synth_one_sample_with_target``,
        ``callbacks/utils.py:11-54``)."""
        from .synth_utils import denormalize, expand_by_duration
        system = self.system
        task = system.acfg["adapt"]["train"]
        sup, qry = sup.to(system.device), qry.to(system.device)
        adapted = system.adaptor.adapt_first_order(system.params, sup, steps=task["steps"],
                                                   lr=task["lr"], train=False)
        qry_c = qry._replace(speaker_args=episode_speaker_args(sup.speaker_args,
                                                               qry.speaker_args))
        out = system.adaptor.forward(adapted, qry_c, train=False, average_spk_emb=True)

        hop = system.pcfg["preprocessing"]["stft"]["hop_length"]
        mel_len = int(qry.mel_lens[0])   # teacher-forced: the prediction's too
        if mel_len <= 0:
            return
        host = lambda t: t.detach().float().cpu().numpy()
        mel_pred = host(out.postnet_mel[0, :mel_len])
        mel_target = host(qry.mels[0, :mel_len])
        for tag, mel in (("reconstructed", mel_target), ("synthesized", mel_pred)):
            wav = self.vocoder.infer(torch.from_numpy(mel[None]),
                                     lengths=[mel_len * hop])[0]
            path = self.saver.save_audio("Validation", f"step_{step}", f"sample.{tag}", wav)
            self.logger.log_artifact(step, "audio", path)

        # the target pitch/energy tracks on both panels (reference
        # synth_one_sample_with_target uses the targets)
        src_len = int(qry.src_lens[0])
        d = host(qry.d_targets[0, :src_len])
        pcfg = system.pcfg["preprocessing"]
        pitch, energy = host(qry.p_targets[0]), host(qry.e_targets[0])
        pitch = (expand_by_duration(pitch[:src_len], d)
                 if pcfg["pitch"]["feature"] == "phoneme_level" else pitch)[:mel_len]
        energy = (expand_by_duration(energy[:src_len], d)
                  if pcfg["energy"]["feature"] == "phoneme_level" else energy)[:mel_len]
        pitch = denormalize(pitch, system.stats["pitch"][2], system.stats["pitch"][3])
        energy = denormalize(energy, system.stats["energy"][2], system.stats["energy"][3])
        fig = self.saver.save_panel_figure(
            "Validation", f"step_{step}", "sample",
            [(mel_pred, pitch, energy), (mel_target, pitch, energy)],
            ["Synthesized Spectrogram", "Ground-Truth Spectrogram"])
        self.logger.log_artifact(step, "figure", fig)

    # -------------------------------------------------------------- test

    def test(self, ckpt_step="last", max_tasks=None, tasks_per_label=None,
             task_batch=None):
        """Few-shot test: adapt on support, synthesize query, save artifacts
        (reference ``base_adaptor.py:136-189`` + Saver test tree).
        ``tasks_per_label`` overrides the per-speaker task count (reference
        default 16).  ``task_batch`` (or ``train.test_task_batch``) runs that
        many tasks through one ``System.test_adapt_batched`` call; "auto" is
        the world size (1 without a process group), and 1-shot mode keeps
        the sequential path.  Under a launcher the batched tasks are sharded
        over the ranks and rank 0 writes every task's files.  Returns task
        id -> rows."""
        system = self.system
        test_cfg = system.acfg["adapt"]["test"]
        main = self._distribute()
        tb = 1 if test_cfg.get("1-shot", False) else self._task_batch(task_batch)
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
            if main:
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

    # --------------------------------------------------- in-loop synthesis

    @torch.no_grad()
    def synth_sample(self, step, batch, episode_batched=False):
        """Every synth_step: reconstruct (teacher-forced) and synthesize the
        batch's first utterance through the vocoder (reference Saver,
        ``saver.py:51-59,214-274``), on the unfused eval forward as in the
        JAX package."""
        system = self.system
        if episode_batched:
            batch = episode(batch, 0)
        one = map_batch(lambda t: t[:1], batch).to(system.device)
        hop = system.pcfg["preprocessing"]["stft"]["hop_length"]
        for tag, teacher in (("recon", None), ("synth", False)):
            out = system.adaptor.forward(system.params, one, train=False,
                                         teacher_forced=teacher)
            mel_len = int(out.mel_lens[0])
            if mel_len <= 0:
                continue
            wav = self.vocoder.infer(out.postnet_mel[:, :mel_len],
                                     lengths=[mel_len * hop])[0]
            path = self.saver.save_audio("Training", f"step_{step}", f"sample.{tag}", wav)
            self.logger.log_artifact(step, "audio", path)
            fig = self.saver.save_mel_figure(
                "Training", f"step_{step}", f"sample.{tag}",
                out.postnet_mel[0, :mel_len].float().cpu().numpy())
            self.logger.log_artifact(step, "figure", fig)
