"""End-to-end demo on the PyTorch port (the counterpart of examples/demo.py).

    python examples/demo_torch.py [--ckpt model.safetensors] [--config tv2o-medium]
                                  [--events 256] [--batch 2] [--out outputs/]
                                  [--device cpu]

Without a checkpoint it runs a randomly initialized bf16 model — useful for
smoke-testing the pipeline; with a reference checkpoint (e.g.
skytnt/midi-model-tv2o-medium's model.safetensors, downloaded beforehand) it
produces music.  It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--config", default="tv2o-medium")
    ap.add_argument("--events", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--prompt-midi", default="", help="optional .mid prompt")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from midi_model_tpu_torch.midi import midi2score, score2midi
    from midi_model_tpu_torch.models import MIDIModelConfig
    from midi_model_tpu_torch.models.midinet import init_model
    from midi_model_tpu_torch.sampling import generate

    if os.path.exists(args.config):
        config = MIDIModelConfig.from_json_file(args.config)
    else:
        config = MIDIModelConfig.from_name(args.config)
    tokenizer = config.tokenizer
    if args.ckpt:
        from midi_model_tpu_torch.interop import load_state_dict, params_from_state_dict

        model = params_from_state_dict(load_state_dict(args.ckpt), config,
                                       dtype=torch.bfloat16, device=args.device)
        print(f"loaded {args.ckpt}")
    else:
        model = init_model(config, seed=0, dtype=torch.bfloat16, device=args.device)
        print("random weights (no --ckpt): output will be noise, but the "
              "pipeline is exercised end to end")
    print(f"device: {model.device}")

    prompt = None
    if args.prompt_midi:
        with open(args.prompt_midi, "rb") as f:
            seq = tokenizer.tokenize(midi2score(f.read()))
        prompt = np.asarray(seq[:256], dtype=np.int64)
        print(f"prompt: {len(seq)} events from {args.prompt_midi}")

    rows = generate(model, config, prompt=prompt, batch_size=args.batch,
                    max_len=args.events, temp=1.0, top_p=0.94, top_k=20,
                    seed=args.seed)
    print(f"generated {rows.shape[1]} events x {rows.shape[0]} samples")

    os.makedirs(args.out, exist_ok=True)
    for i, seq in enumerate(rows):
        score = tokenizer.detokenize([list(r) for r in seq])
        path = os.path.join(args.out, f"demo_{i}.mid")
        with open(path, "wb") as f:
            f.write(score2midi(score))
        n_notes = sum(1 for tr in score[1:] for e in tr if e[0] == "note")
        print(f"  {path}: {n_notes} notes")


if __name__ == "__main__":
    main()
