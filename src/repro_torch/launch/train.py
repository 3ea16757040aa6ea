"""Training launcher: masked-diffusion training with the fault-tolerant
loop, the CLI of ``repro.launch.train``. Runs on the card unless
``--device cpu``.

CPU example (reduced config, a few steps):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch llada-8b --steps 20 --global-batch 4 --seq-len 64

``--full`` trains the published widths. The training path runs torch ops
under autograd and no hand kernel, as the reference's runs no Pallas
kernel.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.train.train_loop import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llada-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tc = TrainConfig(microbatches=args.microbatches, learning_rate=args.lr,
                     grad_compression=args.grad_compression,
                     loss_chunk=min(2048, args.global_batch * args.seq_len))
    os.makedirs(args.ckpt_dir, exist_ok=True)
    tr = Trainer(cfg, tc, args.ckpt_dir, args.global_batch, args.seq_len,
                 seed=args.seed, total_steps=max(args.steps, 100),
                 ckpt_every=args.ckpt_every, device=args.device)
    if tr.start_step:
        print(f"resumed from checkpoint at step {tr.start_step}")
    data = lambda s: synthetic_batch(cfg, args.global_batch, args.seq_len, s,
                                     seed=args.seed)
    logs = tr.run(args.steps, data, quiet=False)
    print(json.dumps({"final_loss": logs[-1]["loss"],
                      "steps": tr.start_step,
                      "stragglers": len(tr.events.stragglers),
                      "checkpoints": tr.events.checkpoints}))


if __name__ == "__main__":
    main()
