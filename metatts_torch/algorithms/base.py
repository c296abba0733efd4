"""System base: owns the model, its optimizer, the step counter and the
chain of seeds the training steps and the test-time adaptation draw their
dropout from.

The JAX package's ``System`` (``algorithms/base.py``): the training step's
shared parts and the test stage (first-order adaptation with a query
evaluation and a parameter snapshot at every saving step), and
``enable_distributed``, its ``enable_mesh``: under a process group each
rank takes its shard of the episode or batch axis and the gradients are
summed over the ranks (``parallel/distributed.py``).
"""

import math
import os

import torch

from ..data.collate import map_batch
from ..models import nn as L
from ..models.fastspeech2 import FastSpeech2
from ..models.loss import LossValues
from ..models.phoneme_embedding import PhonemeEmbedding
from ..train.optim import NoamAdam
from ..utils.tools import resolve_device
from .adapt import Adaptor, episode_speaker_args
from .flags import fp32_products

# snapshot bytes that "auto" keeps on the device: the JAX package's default
# off a TPU (``algorithms/base.py:170-172``), so both packages pick the same
SNAPSHOT_BUDGET = 4e9


def episode(batch, e):
    """Episode ``e`` of a batch stacked on a leading episode axis."""
    return map_batch(lambda t: t[e], batch)


def _plan(saving_steps, max_steps):
    """The saving steps in (0, max_steps], sorted, and the chunk: the gcd
    of the gaps between them (one compiled chunk in the JAX package)."""
    targets = sorted(s for s in saving_steps if 0 < s <= max_steps)
    gaps = [b - a for a, b in zip([0] + targets[:-1], targets)]
    return targets, (math.gcd(*gaps) if gaps else 0)


def _stack(dicts):
    return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}

DEFAULT_STATS = {"pitch": [-3.0, 10.0, 0.0, 1.0],
                 "energy": [-2.0, 10.0, 0.0, 1.0]}


class System:
    def __init__(self, preprocess_cfg, model_cfg, train_cfg, algorithm_cfg,
                 stats=None, n_speakers=8, seed=43, device="cuda"):
        """Random init from ``seed`` on ``device`` (default the card; without
        one it raises unless ``device="cpu"``).  On the card a model
        computing in float32 turns off TF32 for cuDNN's convolutions in the
        process."""
        if isinstance(preprocess_cfg, list):
            preprocess_cfg = preprocess_cfg[0]
        self.device = resolve_device(device)
        fp32_products(model_cfg, self.device)
        self.pcfg = preprocess_cfg
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.acfg = algorithm_cfg
        self.stats = stats or DEFAULT_STATS
        init_seed, train_seed = L.split(seed, 2)
        self.model = FastSpeech2(
            preprocess_cfg, model_cfg, algorithm_cfg, self.stats, n_speakers,
            generator=torch.Generator().manual_seed(init_seed))
        adapt = algorithm_cfg["adapt"]
        if adapt["type"] == "lang" and adapt["phoneme_emb"]["type"] == "codebook":
            # the cross-lingual codebook (reference meta.py:24-33) is a
            # submodule of the model, so its banks are among the parameters
            # the optimizer, the clip and the checkpoints cover
            codebook = PhonemeEmbedding(model_cfg, algorithm_cfg)
            codebook.reset_parameters(torch.Generator().manual_seed(L.fold_in(init_seed, 99)))
            self.model.phn_emb_generator = codebook
        self.model.to(self.device)
        self.adaptor = Adaptor(self.model, preprocess_cfg, model_cfg,
                               algorithm_cfg)
        self.optimizer = NoamAdam(self.params, model_cfg, train_cfg)
        self.global_step = 0
        self._rng = torch.Generator().manual_seed(train_seed)
        self.snapshot_mode = None      # the test stage's, once it has run
        self.shard = None              # set by enable_distributed

    # ------------------------------------------------------- distribution

    def enable_distributed(self):
        """Shard the training step's episode (or flat-batch) axis over the
        ranks of the process group, the counterpart of
        the JAX package's ``enable_mesh``.  Every rank then takes the whole
        batch and computes on its contiguous shard; the gradients are
        summed over the ranks before the clip and the optimizer, so every
        rank applies the same update; validation and the batched test stage
        shard their episodes where the world size divides them and gather
        the rows.  Rank 0's weights are broadcast to every rank.  Returns
        the ``Shard``, or None outside a process group of more than one
        rank (a single-process run is unchanged)."""
        from ..parallel.distributed import Shard, world_size
        if world_size() <= 1:
            return None
        self.shard = Shard()
        self.shard.broadcast_(self.model)
        return self.shard

    def _episodes(self, n, what="meta_batch_size", strict=True):
        """The global indices of the episodes (or rows) of a leading axis of
        ``n`` that this rank computes: all of them outside a process group
        and, unless ``strict``, where the world size does not divide ``n``
        (then every rank computes every one); ``strict`` raises there."""
        if self.shard is None or (not strict and not self.shard.divides(n)):
            return range(n)
        return range(*self.shard.bounds(n, what))

    def _gathered(self, t, n):
        """``t`` over this rank's episodes -> over all ``n`` of them."""
        return t if t.shape[0] == n else self.shard.gather_rows(t)

    def _mean_losses(self, losses, n):
        """The mean over all ``n`` episodes of this rank's LossValues."""
        if self.shard is None:
            return LossValues(*(torch.stack(v).mean() for v in zip(*losses)))
        sums = [torch.stack(v).sum() for v in zip(*losses)]
        self.shard.all_reduce_(sums)
        return LossValues(*(v / n for v in sums))

    @property
    def params(self):
        """name -> Parameter of the model (the optimizer's leaves)."""
        return dict(self.model.named_parameters())

    def next_rng(self):
        """The next seed of the training chain."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._rng))

    def apply_updates(self, grads):
        """One optimizer step from ``grads`` (name -> tensor)."""
        self.optimizer.step(self.params, grads)
        self.global_step += 1

    def _supervised_loss(self, params, batch, seed, train, update_bn_state=False):
        out = self.adaptor.forward(params, batch, train=train, seed=seed,
                                   update_bn_state=update_bn_state)
        losses = self.adaptor.loss(batch, out)
        return losses.total, losses

    # -------------------------------------------------------- validation

    def _val_losses(self, sup, qry, seed):
        task = self.acfg["adapt"]["train"]
        losses, _ = self.adaptor.meta_learn(self.params, sup, qry, steps=task["steps"],
                                            lr=task["lr"], train=False, seed=seed)
        return LossValues(*(v.detach() for v in losses))

    def validation_step(self, sup_batch, qry_batch):
        """First-order adaptation on one episode's support set, evaluated
        on its query set (reference ``base_adaptor.py:107``); every system
        validates so, as the reference shares ``meta_learn``.  Returns
        LossValues."""
        self.model.eval()
        return self._val_losses(sup_batch.to(self.device), qry_batch.to(self.device),
                                self.next_rng())

    def validation_step_batched(self, sup_stack, qry_stack):
        """``validation_step`` over the E episodes of Batches stacked on a
        leading episode axis, one after another; episode e draws from
        ``split(next_rng(), E)[e]``, as the JAX package splits its key.
        Under ``enable_distributed`` each rank runs its shard of the
        episodes and the rows are gathered.  Returns LossValues with (E,)
        fields."""
        self.model.eval()
        E = sup_stack.texts.shape[0]
        sup_stack, qry_stack = sup_stack.to(self.device), qry_stack.to(self.device)
        seeds = L.split(self.next_rng(), E)
        runs = [self._val_losses(episode(sup_stack, e), episode(qry_stack, e), seeds[e])
                for e in self._episodes(E, strict=False)]
        return LossValues(*(self._gathered(torch.stack(v), E) for v in zip(*runs)))

    # --------------------------------------------------- test adaptation

    def _snapshot_keep(self, n_snapshots, episodes=1):
        """The snapshot function of the test stage, per
        ``adapt.test.snapshot_offload``: "device" keeps a snapshot's tensors
        where they are (its frozen tensors are the model's own), "host"
        copies them to the CPU; "auto" keeps them on the device while
        ``n_snapshots * episodes`` copies of every parameter fit
        ``METATTS_SNAPSHOT_HBM_BUDGET`` bytes (default ``SNAPSHOT_BUDGET``).
        The mode taken is left in ``self.snapshot_mode``."""
        mode = self.acfg["adapt"]["test"].get("snapshot_offload", "auto")
        if mode == "auto":
            param_bytes = sum(t.numel() * t.element_size() for n, t in
                              self.model.state_dict().items() if "running" not in n)
            budget = float(os.environ.get("METATTS_SNAPSHOT_HBM_BUDGET",
                                          SNAPSHOT_BUDGET))
            mode = ("device" if n_snapshots * episodes * param_bytes <= budget
                    else "host")
        if mode not in ("device", "host"):
            raise ValueError(f"snapshot_offload {mode!r}: expected auto | device | host")
        self.snapshot_mode = mode
        if mode == "device":
            return lambda p: p
        return lambda p: {k: v.to("cpu") for k, v in p.items()}

    def _start_params(self):
        return {k: v.detach() for k, v in self.params.items()}

    def _adapt_chunk(self, params, sup, steps, lr, seed):
        """``steps`` first-order SGD steps on the support set with dropout
        active (the reference clones the learner and calls ``train()``,
        ``base_adaptor.py:100-111``); BatchNorm statistics stay untouched."""
        return self.adaptor.adapt_first_order(params, sup, steps=steps, lr=lr,
                                              train=True, seed=seed)

    @torch.no_grad()
    def _eval_query(self, params, sup, qry, fused_infer):
        """The query loss on ``params``, deterministic (dropout off, BatchNorm
        running statistics), conditioned on the first support speaker."""
        qry = qry._replace(speaker_args=episode_speaker_args(
            sup.speaker_args, qry.speaker_args))
        out = self.adaptor.forward(params, qry, train=False,
                                   average_spk_emb=True, fused_infer=fused_infer)
        return self.adaptor.loss(qry, out)

    def _trajectory(self, sup, qry, targets, chunk, seeds, keep, fused_infer):
        lr = self.acfg["adapt"]["test"]["lr"]
        params = self._start_params()
        rows = [(0, self._eval_query(params, sup, qry, fused_infer))]
        snapshots = [(0, keep(params))]
        done, seeds = 0, iter(seeds)
        for target in targets:
            for _ in range((target - done) // chunk):
                params = self._adapt_chunk(params, sup, chunk, lr, next(seeds))
            done = target
            rows.append((target, self._eval_query(params, sup, qry, fused_infer)))
            snapshots.append((target, keep(params)))
        return rows, snapshots

    def test_adapt(self, sup_batch, qry_batch, ft_steps=None):
        """Test-time adaptation with snapshot evaluation (reference
        ``base_adaptor.py:136-189``): first-order SGD on the support set in
        chunks of the gcd of the saving-step gaps, each chunk drawing its
        dropout seed from ``next_rng()``, and at step 0 and every saving
        step the query loss (deterministic, on the fused FFT blocks) and a
        snapshot of every parameter.

        Returns ``(rows, snapshots)``: lists of ``(ft_step, LossValues)``
        and ``(ft_step, name -> tensor)``."""
        test_cfg = self.acfg["adapt"]["test"]
        targets, chunk = _plan(ft_steps or test_cfg["saving_steps"],
                               test_cfg["steps"])
        seeds = [self.next_rng() for _ in range(targets[-1] // chunk if targets else 0)]
        keep = self._snapshot_keep(len(targets) + 1)
        return self._trajectory(sup_batch.to(self.device), qry_batch.to(self.device),
                                targets, chunk, seeds, keep, True)

    def test_adapt_batched(self, sup_stack, qry_stack, ft_steps=None):
        """``test_adapt`` over the E episodes of Batches stacked on a leading
        episode axis, one episode after another, on unfused FFT blocks as in
        the JAX package (its fused kernel has no per-episode weights).  Each
        chunk draws one seed from ``next_rng()`` and episode e takes
        ``split(seed, E)[e]``, as the JAX package splits its key, so only
        the dropout bits differ from it.  Under ``enable_distributed`` each
        rank runs its shard of the episodes and every rank gets all rows
        and snapshots.

        Returns ``(rows, snapshots)`` with every loss and every snapshot
        tensor stacked on a leading E axis."""
        test_cfg = self.acfg["adapt"]["test"]
        targets, chunk = _plan(ft_steps or test_cfg["saving_steps"],
                               test_cfg["steps"])
        E = sup_stack.texts.shape[0]
        seeds = [L.split(self.next_rng(), E)
                 for _ in range(targets[-1] // chunk if targets else 0)]
        keep = self._snapshot_keep(len(targets) + 1, episodes=E)
        sup_stack, qry_stack = sup_stack.to(self.device), qry_stack.to(self.device)
        runs = [self._trajectory(episode(sup_stack, e), episode(qry_stack, e),
                                 targets, chunk, [s[e] for s in seeds], keep, None)
                for e in self._episodes(E, strict=False)]
        rows = [(ft, LossValues(*(self._gathered(torch.stack(v), E) for v in
                                  zip(*(run[0][i][1] for run in runs)))))
                for i, (ft, _) in enumerate(runs[0][0])]
        snapshots = [(ft, {k: self._gathered(v, E) for k, v in
                           _stack([run[1][i][1] for run in runs]).items()})
                     for i, (ft, _) in enumerate(runs[0][1])]
        return rows, snapshots

    def test_adapt_tasks(self, sup_batch, qry_batch, ft_steps=None):
        """Yield ``(suffix, rows, snapshots)`` per test sub-task: one with
        suffix "" in the standard mode; in 1-shot mode
        (``adapt.test.1-shot``) K independent trajectories, one per support
        utterance, each with the whole query batch and suffix ``_<i>``
        (reference ``base_adaptor.py:139-147``), run as one
        ``test_adapt_batched`` call unless ``batch_sub_tasks`` is false."""
        test_cfg = self.acfg["adapt"]["test"]
        if not test_cfg.get("1-shot", False):
            rows, snapshots = self.test_adapt(sup_batch, qry_batch, ft_steps)
            yield "", rows, snapshots
            return
        K = sup_batch.texts.shape[0]
        if test_cfg.get("batch_sub_tasks", True) and K > 1:
            sup_K = map_batch(lambda t: t[:, None], sup_batch)
            qry_K = map_batch(lambda t: t[None].expand(K, *t.shape), qry_batch)
            rows_K, snaps_K = self.test_adapt_batched(sup_K, qry_K, ft_steps)
            for i in range(K):
                rows = [(ft, LossValues(*(float(v[i]) for v in vals)))
                        for ft, vals in rows_K]
                snapshots = [(ft, {k: v[i] for k, v in snap.items()})
                             for ft, snap in snaps_K]
                yield f"_{i}", rows, snapshots
            return
        for i in range(K):
            sup_i = map_batch(lambda t: t[i:i + 1], sup_batch)
            rows, snapshots = self.test_adapt(sup_i, qry_batch, ft_steps)
            yield f"_{i}", rows, snapshots
