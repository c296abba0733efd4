"""The port's CLI (the root ``main.py`` stays the JAX package's):

    python -m metatts_torch -s {train,test,predict,debug}
                            -p <preprocess.yaml>... -m <model.yaml>
                            -t <train.yaml>... -a <algorithm.yaml>
                            [-e exp_name] [-c ckpt_path] [--device cuda|cpu]

  train   -- ``Trainer.fit`` of the algorithm's system (baseline, meta or
             imaml):
             validation, in-loop synthesis and checkpoints at the train
             config's cadences; ``-c`` resumes from a checkpoint of either
             package (weights, step and optimizer state)
  test    -- few-shot adaptation + synthesis over the frozen test tasks
  predict -- synthesize every line of a TextDataset ``--source`` file
  debug   -- read every sample of the test set once and print the count

For test and predict, ``-c`` loads a checkpoint of either package under
the surgery rules.  Under a launcher (``torchrun --nproc_per_node N -m
metatts_torch -s train ...``; ``WORLD_SIZE`` > 1) every rank joins the
process group on ``cuda:LOCAL_RANK`` (gloo ranks with ``--device cpu``)
before the system is built, and ``Trainer`` shards the steps over them.
"""

import argparse
import json
import os

import torch

from . import config as C


def build(configs, log_dir=".", device="cuda"):
    """(system, datamodule) of the configs, as the JAX ``main.build``: the
    system and datamodule of the algorithm's type, the stats and speaker
    count from the first corpus's preprocessed files where they exist."""
    from .algorithms import get_system
    from .data.datamodule import get_datamodule

    preprocess_cfgs, model_cfg, train_cfg, algorithm_cfg = configs
    root = preprocess_cfgs[0]["path"]["preprocessed_path"]
    stats, n_speakers = None, 8
    if os.path.exists(os.path.join(root, "stats.json")):
        with open(os.path.join(root, "stats.json")) as f:
            stats = json.load(f)
    if os.path.exists(os.path.join(root, "speakers.json")):
        with open(os.path.join(root, "speakers.json")) as f:
            n_speakers = max(len(json.load(f)), 1)
    spk_refer_wav = algorithm_cfg["adapt"]["speaker_emb"] in (
        "encoder", "dvec", "scratch_encoder")
    kind = algorithm_cfg["type"]
    dm = get_datamodule(kind)(preprocess_cfgs, train_cfg, algorithm_cfg,
                              log_dir=log_dir, spk_refer_wav=spk_refer_wav)
    system = get_system(kind)(preprocess_cfgs, model_cfg, train_cfg, algorithm_cfg,
                 stats=stats, n_speakers=n_speakers, device=device)
    return system, dm


def main(args, configs):
    from .models.vocoder import Vocoder
    from .train.checkpoint import load_checkpoint
    from .train.loop import Trainer

    from .parallel.distributed import init_from_env

    log_dir = os.path.join(args.output_dir, "log", args.exp_name)
    os.makedirs(log_dir, exist_ok=True)
    device = init_from_env(device=args.device) or args.device
    system, dm = build(configs, log_dir=log_dir, device=device)
    if args.ckpt_path and args.stage != "train":
        _, _, report = load_checkpoint(args.ckpt_path, system.model)
        for r in report:
            print(f"[ckpt surgery] {r}")
    n_mels = configs[0][0]["preprocessing"]["mel"]["n_mel_channels"]
    if args.stage == "predict":
        predict(args, configs, system, Vocoder(configs[1], n_mels=n_mels,
                                               device=system.device))
        return
    dm.setup()
    if args.stage == "debug":
        n = 0
        for i in range(len(dm.test_set)):
            _ = dm.test_set[i]
            n += 1
        print(f"debug: iterated {n} test samples OK")
        return
    vocoder = (None if args.no_synth
               else Vocoder(configs[1], n_mels=n_mels, device=system.device))
    trainer = Trainer(system, dm, configs[2], output_dir=args.output_dir,
                      exp_name=args.exp_name, vocoder=vocoder)
    if args.stage == "train":
        trainer.fit(resume_from=args.ckpt_path, max_steps=args.max_steps)
    else:
        trainer.test(max_tasks=args.max_tasks, tasks_per_label=args.tasks_per_label)


@torch.no_grad()
def predict(args, configs, system, vocoder, predict_batch=8):
    """Text-only synthesis through the vocoder (reference ``main.py:132-139``),
    sources grouped by text bucket, batches of up to ``predict_batch``."""
    from .data.collate import TEXT_BUCKET, collate_batch
    from .data.dataset import TextDataset
    from .train.saver import Saver
    from .utils.tools import bucket_length

    if not args.source:
        raise SystemExit("predict requires --source <file.txt>")
    ds = TextDataset(args.source, configs[0][0])
    groups = {}
    for s in (ds[i] for i in range(len(ds))):
        groups.setdefault(bucket_length(len(s["text"]), TEXT_BUCKET), []).append(s)
    hop = configs[0][0]["preprocessing"]["stft"]["hop_length"]
    saver = Saver(os.path.join(args.output_dir, "log", args.exp_name),
                  os.path.join(args.output_dir, "result", args.exp_name))
    system.model.eval()
    for L in sorted(groups):
        grp = groups[L]
        for i in range(0, len(grp), predict_batch):
            batch, meta = collate_batch(grp[i:i + predict_batch], with_mels=False,
                                        fixed_text_len=L)
            out = system.adaptor.forward(system.params, batch.to(system.device),
                                         train=False, teacher_forced=False,
                                         fused_infer=True)
            wavs = vocoder.infer(out.postnet_mel,
                                 lengths=out.mel_lens.cpu().numpy() * hop)
            for j, w in enumerate(wavs):
                path = saver.save_audio("Prediction", "predict", meta.ids[j], w)
                print(f"wrote {path}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m metatts_torch")
    parser.add_argument("-s", "--stage", type=str, default="test",
                        choices=["train", "test", "predict", "debug"])
    parser.add_argument("-p", "--preprocess_config", type=str, nargs="+",
                        default=["config/preprocess/miniLibriTTS.yaml"])
    parser.add_argument("-m", "--model_config", type=str,
                        default="config/model/dev.yaml")
    parser.add_argument("-t", "--train_config", type=str, nargs="+",
                        default=["config/train/base.yaml",
                                 "config/train/dev.yaml"])
    parser.add_argument("-a", "--algorithm_config", type=str,
                        default="config/algorithm/dev.yaml")
    parser.add_argument("-e", "--exp_name", type=str, default="dev")
    parser.add_argument("-c", "--ckpt_path", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default="output")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="train to this step instead of step.total_step")
    parser.add_argument("--max_tasks", type=int, default=None)
    parser.add_argument("--tasks_per_label", type=int, default=None,
                        help="test tasks per speaker (default 16, as in the "
                             "reference)")
    parser.add_argument("--source", type=str, default=None,
                        help="text source file for the predict stage")
    parser.add_argument("--no_synth", action="store_true",
                        help="train or test without the vocoder (no audio)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def load_configs(args):
    return (C.load_preprocess_configs(args.preprocess_config),
            C.load_model_config(args.model_config),
            C.load_train_configs(args.train_config),
            C.load_algorithm_config(args.algorithm_config))


if __name__ == "__main__":
    _args = parse_args()
    main(_args, load_configs(_args))
