"""Port: data parallelism over ``torch.distributed``
(``metatts_torch/parallel/distributed.py``, ``System.enable_distributed``)
against the single-process port, as ``tests/test_parallel.py`` holds the
JAX package's sharded steps against its unsharded ones.

The test starts 2 gloo ranks once (this file run as a script, a
``file://`` store under ``tmp_path``, so no port is opened and parallel
test workers cannot collide); each rank builds the same tiny systems
(fp32, hidden 32, 1 + 1 layers, seed 3), enables distribution, runs every
case on its shard and saves what it got; the test waits on both ranks
against one deadline, ``RANK_DEADLINE``, and kills both when either fails
or the deadline passes.  The tests run the same cases in
one process and compare: a meta step (2 episodes), two baseline steps on a
batch of 4 whose halves hold 78 and 21 valid mel frames (the losses divide
by the whole batch's count, BatchNorm normalises with the whole batch's
statistics and updates its running state from them, dropout keeps each
row's mask), an iMAML step, ``validation_step_batched`` and
``test_adapt_batched`` (2 episodes each).  Dropout stays on: a rank draws
the whole batch's masks, or its episodes' global seeds.

Tolerance: rtol and atol 2e-4 (``tests/test_parallel.py``'s), on losses,
the gradients the optimizer gets, parameters, BatchNorm buffers, rows and
snapshots; the two ranks hold the
same parameters bit for bit.  Adam's eps is 1e-6 (as in
``tests/test_torch_fit.py``): the gradient of a conv bias in front of a
BatchNorm is 0 up to rounding, and at eps 1e-9 Adam moves it by about lr
in the direction the rounding of the sum over ranks sets.  No JAX here: the cases hold the port
against itself.  An episode axis the world size does not divide raises,
checked without ranks.
"""

import copy
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from metatts_torch import config as C  # noqa: E402
from metatts_torch.algorithms import get_system  # noqa: E402
from metatts_torch.data.collate import Batch, stack_batches  # noqa: E402

TOL = 2e-4
WORLD = 2
STATS = {"pitch": [-2.0, 8.0, 0.0, 1.0], "energy": [-1.5, 8.0, 0.0, 1.0]}
CASES = ("meta", "baseline", "imaml", "validation", "test_batched")
# seconds both ranks get together: the whole test takes 19-41 s in the test suite
RANK_DEADLINE = 180


def _configs(kind):
    mcfg = copy.deepcopy(C.MODEL_DEFAULTS)
    mcfg["transformer"].update(
        encoder_layer=1, decoder_layer=1, encoder_hidden=32, decoder_hidden=32,
        encoder_head=2, decoder_head=2, conv_filter_size=48)
    mcfg["variance_predictor"].update(filter_size=16)
    mcfg["variance_embedding"].update(n_bins=16)
    mcfg.update(max_seq_len=64, compute_dtype="float32", activation_dtype="float32",
                attention_scores_dtype="float32", remat=False)
    pcfg = copy.deepcopy(C.PREPROCESS_DEFAULTS)
    pcfg["preprocessing"]["mel"]["n_mel_channels"] = 8
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    tcfg["optimizer"].update(warm_up_step=50, eps=1e-6)
    acfg = copy.deepcopy(C.ALGORITHM_DEFAULTS)
    acfg["type"] = kind
    acfg["adapt"]["train"].update(steps=2, shots=2, queries=2, meta_batch_size=WORLD)
    acfg["adapt"]["test"].update(steps=2, saving_steps=[1, 2])
    acfg["adapt"]["imaml"].update(cg_steps=2)
    return pcfg, mcfg, tcfg, acfg


def _system(kind):
    return get_system(kind)(*_configs(kind), stats=STATS, n_speakers=4, seed=3,
                            device="cpu")


def _batch(rng, mel_lens, src_lens, L=12, T=48, n_mels=8):
    """A teacher-forced Batch whose durations sum to each row's mel length
    over its valid phones."""
    B = len(mel_lens)
    d = np.zeros((B, L), np.int32)
    for b, (m, s) in enumerate(zip(mel_lens, src_lens)):
        d[b, :s] = m // s
        d[b, :m % s] += 1
    t = torch.from_numpy
    return Batch(
        speaker_args=t(rng.randint(0, 4, B).astype(np.int32)),
        texts=t(rng.randint(1, 300, (B, L)).astype(np.int32)),
        src_lens=t(np.asarray(src_lens, np.int32)),
        mels=t(rng.randn(B, T, n_mels).astype(np.float32)),
        mel_lens=t(np.asarray(mel_lens, np.int32)),
        p_targets=t(rng.randn(B, L).astype(np.float32)),
        e_targets=t(rng.randn(B, L).astype(np.float32)),
        d_targets=t(d))


def _episodes(seed, E=WORLD, shots=2):
    rng = np.random.RandomState(seed)
    eps = [(_batch(rng, [40, 31], [12, 9]), _batch(rng, [44, 20], [12, 6]))
           for _ in range(E)]
    return (stack_batches([e[0] for e in eps]), stack_batches([e[1] for e in eps]))


def _params(system):
    return {f"p/{k}": v.detach().numpy().copy() for k, v in system.params.items()}


def _buffers(system):
    return {f"b/{k}": v.detach().numpy().copy() for k, v in system.model.named_buffers()}


def _losses(tag, lv):
    return {f"{tag}/{k}": np.asarray(v.detach()) for k, v in zip(lv._fields, lv)}


def run_case(case, distributed):
    """The case's results (name -> array) from a fresh system, sharded over
    the process group when ``distributed``."""
    kind = {"validation": "meta", "test_batched": "baseline"}.get(case, case)
    system = _system(kind)
    if distributed:
        assert system.enable_distributed() is not None
    out = {}
    apply = system.apply_updates

    def record(grads):   # the gradient the optimizer gets, summed over ranks
        out.update({f"g{system.global_step}/{k}": v.detach().numpy().copy()
                    for k, v in grads.items() if v is not None})
        apply(grads)
    system.apply_updates = record
    if case in ("meta", "imaml"):
        out.update(_losses("step", system.train_step(*_episodes(0))))
    elif case == "baseline":
        rng = np.random.RandomState(1)
        # rows 0-1 (rank 0) hold 78 valid frames and 22 phones, rows 2-3 21 and 8
        batch = _batch(rng, [40, 38, 12, 9], [12, 10, 5, 3])
        for i in range(2):
            out.update(_losses(f"step{i}", system.train_step(batch)))
        out.update(_buffers(system))
    elif case == "validation":
        out.update(_losses("val", system.validation_step_batched(*_episodes(2))))
    else:
        rows, snapshots = system.test_adapt_batched(*_episodes(4))
        for ft, lv in rows:
            out.update(_losses(f"row{ft}", lv))
        for ft, snap in snapshots:
            out.update({f"snap{ft}/{k}": v.numpy() for k, v in snap.items()})
        return out
    out.update(_params(system))
    return out


def _rank_main(rank, store, out_dir):
    """One rank: join the gloo group through the file store, run every
    case, save the results as ``<out_dir>/rank<rank>.npz``."""
    from metatts_torch.parallel.distributed import init_from_env
    torch.set_num_threads(1)
    init_from_env(init_method=f"file://{store}", rank=rank, world_size=WORLD,
                  device="cpu")
    got = {}
    for case in CASES:
        got.update({f"{case}:{k}": v for k, v in run_case(case, True).items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    torch.distributed.destroy_process_group()


def _start(cmd, log, env=None):
    """Start ``cmd`` with its output (and errors) in the file ``log``, a
    ``pathlib.Path``."""
    with open(log, "wb") as f:
        return subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT)


def _wait_all(procs, logs, seconds):
    """Wait for every process of ``procs`` against one deadline ``seconds``
    from now.  When one exits non-zero or the deadline passes, kill the
    others and fail with every process's log (``logs``, their files)."""
    start = time.monotonic()
    try:
        while (None in [p.poll() for p in procs] and not any(p.returncode for p in procs)
               and time.monotonic() - start < seconds):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        head = (f"exit codes {codes} (-9: killed); the wait ended after "
                f"{time.monotonic() - start:.1f} s of its {seconds} s deadline")
        raise AssertionError("\n".join(
            [head] + [f"--- process {i}:\n" + log.read_bytes().decode(errors="replace")[-3000:]
                      for i, log in enumerate(logs)]))


def _ranks(d):
    """Both ranks' results, from one start of the 2-rank group in ``d``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    logs = [d / f"rank{r}.log" for r in range(WORLD)]
    procs = [_start([sys.executable, os.path.abspath(__file__), str(r),
                     str(d / "store"), str(d)], logs[r], env)
             for r in range(WORLD)]
    _wait_all(procs, logs, RANK_DEADLINE)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _check_case(case, ranks):
    want = run_case(case, False)
    for r, got in enumerate(ranks):
        mine = {k.split(":", 1)[1]: v for k, v in got.items() if k.startswith(case + ":")}
        assert mine.keys() == want.keys(), (r, sorted(set(mine) ^ set(want)))
        for k in want:
            np.testing.assert_allclose(mine[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {case} {k}")
    for k in ranks[0]:
        if k.startswith(case + ":") and ":p/" in k:
            assert np.array_equal(ranks[0][k], ranks[1][k]), k


def _check_indivisible_raises():
    """An episode axis the world size does not divide raises the JAX
    package's message before any collective."""
    from metatts_torch.parallel.distributed import Shard
    system = _system("meta")
    shard = Shard.__new__(Shard)
    shard.rank, shard.world = 0, WORLD
    system.shard = shard
    sup, qry = _episodes(0, E=3)
    with pytest.raises(ValueError, match="meta_batch_size=3 must be a multiple of the 2-device"):
        system.train_step(sup, qry)


def test_two_ranks_match_one_process(tmp_path):
    """Every case of the module docstring, in one test: pytest-xdist's
    ``--dist loadfile`` queues the files with the most tests first, so a
    file of few tests runs after the suite's long files have started
    instead of ahead of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_indivisible_raises()
        ranks = _ranks(tmp_path)
        for case in CASES:
            _check_case(case, ranks)
    finally:
        torch.set_num_threads(n)


def test_a_child_that_never_exits_is_killed_at_the_deadline(tmp_path):
    """``_ranks``'s wait kills a process that outlives the deadline and fails
    with its log, instead of holding the test worker; a process that exits
    non-zero ends the wait at once and takes the others down with it."""
    sleeper = [sys.executable, "-c", "import time; time.sleep(600)"]
    logs = [tmp_path / "sleep.log"]
    procs = [_start(sleeper, logs[0])]
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match=r"exit codes \[-9\] .* of its 2 s deadline"):
        _wait_all(procs, logs, 2)
    assert 2 <= time.monotonic() - t0 < 10
    assert procs[0].returncode is not None

    logs = [tmp_path / "sleep2.log", tmp_path / "fail.log"]
    procs = [_start(sleeper, logs[0]),
             _start([sys.executable, "-c", "raise SystemExit('rank died')"], logs[1])]
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="rank died"):
        _wait_all(procs, logs, RANK_DEADLINE)
    assert time.monotonic() - t0 < 30
    assert procs[0].returncode is not None and procs[1].returncode == 1


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
