"""Offline corpus preprocessing — the dataset_preprocess.ipynb equivalent.

    python -m midi_model_tpu_torch.train.preprocess --src raw_midis --dst dataset

Counterpart of ``midi_model_tpu/train/preprocess.py``, on the host only (no
torch device): parallel-filters a MIDI corpus through the port's ``midi``
codec and ``tokenizer`` (native where they build, ``native/``) — size
gates, parse + tokenize, ``check_quality``; good files are copied to
``dst/processed/``, rejects to ``dst/bad/<reason>/``.  Uses a process pool
in batches to keep memory flat at corpus scale.  The pool's workers are
spawned, not forked: a caller may hold a CUDA context and threads (the
serving app, ``chip_smoke.py``), which a forked child must not inherit.
A worker imports this module, the codec and the tokenizer, but not torch.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Tuple

from ..midi import midi2score
from ..tokenizer import MIDITokenizer

MIN_SIZE = 3000
MAX_SIZE = 384000


def process_file(args: Tuple[str, str, bool]) -> Tuple[str, Optional[str]]:
    """Returns (path, None) when accepted or (path, reason) when rejected."""
    path, tok_version, optimise = args
    try:
        size = os.path.getsize(path)
        if size > MAX_SIZE:
            return path, "too_large"
        if size < MIN_SIZE:
            return path, "too_small"
        with open(path, "rb") as f:
            score = midi2score(f.read())
        if max([0] + [len(t) for t in score[1:]]) == 0:
            return path, "empty"
        tok = MIDITokenizer(tok_version)
        tok.set_optimise_midi(optimise)
        seq = tok.tokenize(score)
        ok, reasons = tok.check_quality(seq)
        if not ok:
            return path, "_".join(reasons)
        return path, None
    except Exception:
        return path, "parse_error"


def main(argv=None):
    """Filter ``--src`` into ``--dst``; returns ``(accepted, rejected)``."""
    ap = argparse.ArgumentParser(description="filter a midi corpus by quality")
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--tokenizer", default="v2", choices=["v1", "v2"])
    ap.add_argument("--optimise", action="store_true", default=True)
    ap.add_argument("--jobs", type=int, default=os.cpu_count())
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--move", action="store_true",
                    help="move files instead of copying")
    args = ap.parse_args(argv)

    from .data import find_midi_files

    files = find_midi_files(args.src)
    print(f"{len(files)} midi files under {args.src}")
    processed_dir = os.path.join(args.dst, "processed")
    os.makedirs(processed_dir, exist_ok=True)
    transfer = shutil.move if args.move else shutil.copy2

    accepted = rejected = 0
    with ProcessPoolExecutor(max_workers=args.jobs,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        work = [(f, args.tokenizer, args.optimise) for f in files]
        for i in range(0, len(work), args.batch):
            for path, reason in pool.map(process_file, work[i: i + args.batch]):
                if reason is None:
                    transfer(path, os.path.join(processed_dir, os.path.basename(path)))
                    accepted += 1
                else:
                    bad_dir = os.path.join(args.dst, "bad", reason)
                    os.makedirs(bad_dir, exist_ok=True)
                    transfer(path, os.path.join(bad_dir, os.path.basename(path)))
                    rejected += 1
            done = min(i + args.batch, len(work))
            print(f"[{done}/{len(work)}] accepted={accepted} rejected={rejected}")
    print(f"done: {accepted} accepted, {rejected} rejected")
    return accepted, rejected


if __name__ == "__main__":
    main()
