"""Quickstart (``examples/quickstart.py`` of the reference): train a small
MoE LM end-to-end, then serve it with the paper's adaptive
mixture-of-precisions planner. On the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--steps 200] [--device cpu]

Walks the full public API surface:
  1. config   — a reduced Mixtral-family MoE;
  2. data     — deterministic synthetic corpus pipeline;
  3. training — the train step (AdamW, microbatched grad accumulation);
  4. planning — the planner: memory budget -> precision/placement plan;
  5. serving  — the adaptive engine: batched prefill/decode under the
                plan (on the card, the expert banks run the CUDA kernels).
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import (DataPipeline, SyntheticCorpus,
                                       SyntheticCorpusConfig)
from repro_torch.device import resolve_device
from repro_torch.launch.train import batch_to
from repro_torch.models.model import build_model, init_params
from repro_torch.serving.api import EngineConfig, build_engine
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="mixtral-8x7b",
                    help="any MoE arch id; reduced to a small model")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. config — the paper's model family, smoke-reduced
    cfg = reduce_for_smoke(get_config(args.arch)).replace(
        num_layers=4, d_model=128, vocab_size=512, vocab_pad_multiple=128)
    print(f"[1] config: {cfg.arch_id} {cfg.num_layers}L d={cfg.d_model} "
          f"E={cfg.moe.num_experts} top{cfg.moe.top_k} "
          f"({cfg.param_count()/1e6:.1f}M params)")

    # 2. data
    corpus = SyntheticCorpus(SyntheticCorpusConfig(vocab_size=cfg.vocab_size))
    pipe = DataPipeline(corpus, batch=8, seq=128)

    # 3. training
    model = build_model(cfg)
    params = init_params(cfg, seed=0, device=device)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=20,
                                     total_steps=args.steps),
                       num_microbatches=2)
    state = init_train_state(params, tcfg)
    step = make_train_step(model.loss_fn, tcfg)
    print(f"[3] training {args.steps} steps ...")
    for i in range(args.steps):
        params, state, metrics = step(params, state,
                                      batch_to(pipe.next_batch(), device))
        if i % 50 == 0 or i == args.steps - 1:
            print(f"    step {i:4d}  nll={float(metrics['nll']):.4f}  "
                  f"lb={float(metrics.get('load_balance', 0.0)):.4f}")
    del state

    # 4+5. adaptive serving under a shrinking memory budget
    engine = build_engine(cfg, params, EngineConfig(
        max_slots=4, max_len=64, use_kernel=device.type == "cuda"),
        device=device)
    full = engine.planner.size_ne + engine.planner.num_experts_total \
        * engine.planner.size_e16
    rng = np.random.default_rng(0)
    for frac in (1.1, 0.6, 0.35):
        budget = full * frac
        res = engine.configure(budget, "throughput")
        print(f"[4] budget={budget/1e6:6.1f}MB -> {res.summary()}")
        for _ in range(4):
            engine.submit(rng.integers(1, cfg.vocab_size, 12),
                          max_new_tokens=12)
        while engine.step():
            pass
        print(f"[5] {engine.summary()}")
    rid, req = next(iter(engine.done.items()))
    print(f"    sample output (req {rid}): {req.out_tokens}")
    engine.close()


if __name__ == "__main__":
    main()
