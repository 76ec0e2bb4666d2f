"""Model FLOPs of the stretch's client SGD steps (forward and backward, the
recompute not counted) and evaluation forwards, over the stretch's length
times the card's bf16 peak (%)."""
from bench import yardstick as Y


def read(rec):
    model, tr = rec.cell["model"], rec.cell["traffic"]
    flops = (rec.counts["sgd_steps"]
             * Y.train_step_flops(model, tr["batch"], tr["seq_len"])
             + rec.counts["evals"]
             * Y.forward_flops(model, tr["eval_seqs"], tr["seq_len"]))
    return 100.0 * flops / (rec.seconds * Y.BF16_FLOPS_PER_S)
