"""Host-side training data pipeline.

Counterpart of ``midi_model_tpu/train/data.py``, on the port's own
``tokenizer`` and ``midi`` copies; the same semantics as the reference
dataset:

- file-size gates (3 kB–384 kB) before parsing;
- MIDI bytes -> score -> tokenize -> optional check_quality -> optional augment;
- ANY failure resamples a uniformly random other file;
- random crop to ``max_len`` rows with a 50% chance of forcing start 0 for
  training; deterministic strided crop for validation;
- pad-collate with pad_id; training batches pad to the fixed ``max_len``,
  so every step has one shape.

Tokenizing is pure Python and GIL-bound, so the loader prefetches batches
from a pool of worker processes.  The workers are spawned, not forked: the
trainer's process holds CUDA and torch's threads, which a fork must not
copy.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence

import numpy as np

from ..midi import midi2score
from ..tokenizer import MIDITokenizer

EXTENSIONS = (".mid", ".midi")


def find_midi_files(path: str) -> List[str]:
    """Recursively list midi files, sorted (ref get_midi_list, train.py:273-282)."""
    found = {
        os.path.join(root, fname)
        for root, _dirs, files in os.walk(path)
        for fname in files
    }
    return sorted(f for f in found if os.path.splitext(f)[1].lower() in EXTENSIONS)


class MidiDataset:
    """Index-addressable dataset of token sequences."""

    def __init__(self, midi_files: Sequence[str], tokenizer=None,
                 max_len: int = 2048, min_file_size: int = 3000,
                 max_file_size: int = 384000, aug: bool = True,
                 check_quality: bool = False, rand_start: bool = True,
                 seed: Optional[int] = None):
        self.midi_files = list(midi_files)
        self.tokenizer = tokenizer or MIDITokenizer("v2")
        self.max_len = max_len
        self.min_file_size = min_file_size
        self.max_file_size = max_file_size
        self.aug = aug
        self.check_quality = check_quality
        self.rand_start = rand_start
        self.rng = random.Random(seed) if seed is not None else random

    def __len__(self) -> int:
        return len(self.midi_files)

    def load_midi(self, index: int, _depth: int = 0) -> list:
        """Tokenize one file; on any failure retry a random other file."""
        try:
            path = self.midi_files[index]
            size = os.path.getsize(path)
            if size > self.max_file_size:
                raise ValueError("file too large")
            if size < self.min_file_size:
                raise ValueError("file too small")
            with open(path, "rb") as f:
                score = midi2score(f.read())
            if max([0] + [len(track) for track in score[1:]]) == 0:
                raise ValueError("empty track")
            seq = self.tokenizer.tokenize(score)
            if self.check_quality and not self.tokenizer.check_quality(seq)[0]:
                raise ValueError("bad quality")
            if self.aug:
                seq = self.tokenizer.augment(seq, rng=self.rng)
            return seq
        except Exception:
            if _depth > 64:  # bounded, unlike the reference's unbounded recursion
                raise
            return self.load_midi(self.rng.randint(0, len(self) - 1), _depth + 1)

    def __getitem__(self, index: int) -> np.ndarray:
        seq = np.asarray(self.load_midi(index), dtype=np.int32)
        if self.rand_start:
            start = self.rng.randrange(0, max(1, seq.shape[0] - self.max_len))
            start = self.rng.choice([0, start])
        else:
            max_start = max(1, seq.shape[0] - self.max_len)
            start = (index * (max_start // 8)) % max_start
        return seq[start: start + self.max_len]

    def collate(self, items: List[np.ndarray], pad_to: Optional[int] = None
                ) -> np.ndarray:
        """Stack + pad rows with pad_id.  ``pad_to=None`` pads to the batch max
        (reference behavior); training passes ``max_len`` for static shapes."""
        pad_id = self.tokenizer.pad_id
        t = self.tokenizer.max_token_seq
        target = pad_to or max(len(s) for s in items)
        out = np.full((len(items), target, t), pad_id, dtype=np.int32)
        for i, s in enumerate(items):
            out[i, : len(s)] = s[:target]
        return out


def _load_batch(args):
    """Process-pool worker: materialize one batch."""
    files, tok_version, optimise, indices, kwargs, pad_to, seed = args
    tok = MIDITokenizer(tok_version)
    tok.set_optimise_midi(optimise)
    ds = MidiDataset(files, tok, seed=seed, **kwargs)
    return ds.collate([ds[i] for i in indices], pad_to=pad_to)


class DataLoader:
    """Shuffling, prefetching batch loader over a process pool.

    Yields ``[B, max_len, T]`` int32 arrays indefinitely (epoch reshuffles).
    """

    def __init__(self, dataset: MidiDataset, batch_size: int, workers: int = 4,
                 prefetch: int = 4, seed: int = 0, pad_to_max: bool = True):
        self.ds = dataset
        self.batch_size = batch_size
        self.workers = workers
        self.prefetch = prefetch
        self.seed = seed
        self.pad_to = dataset.max_len if pad_to_max else None

    def _batches(self):
        rng = random.Random(self.seed)
        epoch = 0
        while True:
            order = list(range(len(self.ds)))
            rng.shuffle(order)
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                yield order[i: i + self.batch_size], epoch
            epoch += 1

    def __iter__(self):
        ds = self.ds
        kwargs = dict(max_len=ds.max_len, min_file_size=ds.min_file_size,
                      max_file_size=ds.max_file_size, aug=ds.aug,
                      check_quality=ds.check_quality, rand_start=ds.rand_start)
        if self.workers <= 0:
            for indices, _ in self._batches():
                yield ds.collate([ds[i] for i in indices], pad_to=self.pad_to)
            return

        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        pool = ProcessPoolExecutor(max_workers=self.workers,
                                   mp_context=multiprocessing.get_context("spawn"))
        try:
            batches = self._batches()
            pending = []
            for _ in range(self.prefetch):
                indices, epoch = next(batches)
                pending.append(pool.submit(_load_batch, (
                    ds.midi_files, ds.tokenizer.version, ds.tokenizer.optimise_midi,
                    indices, kwargs, self.pad_to, self.seed + epoch)))
            while True:
                batch = pending.pop(0).result()
                indices, epoch = next(batches)
                pending.append(pool.submit(_load_batch, (
                    ds.midi_files, ds.tokenizer.version, ds.tokenizer.optimise_midi,
                    indices, kwargs, self.pad_to, self.seed + epoch)))
                yield batch
        finally:  # closing the iterator stops the workers
            pool.shutdown(wait=True, cancel_futures=True)
