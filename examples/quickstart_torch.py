"""Quickstart on the PyTorch port: the same tiny SEAFL experiment as
examples/quickstart.py, through ``repro_torch``.

20 heterogeneous clients (Zipf idle times), Dirichlet non-IID shards, K=5
buffered semi-async aggregation with the adaptive staleness+similarity
weights of Eqs. (4)-(8), run to a target accuracy; prints the
accuracy-vs-simulated-wall-clock curve.  Runs on the CUDA card by default
(the server's aggregation launches the seafl_agg kernels there);
``--device cpu`` runs the plain versions instead.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.server import FLConfig  # noqa: E402
from repro_torch.experiment import ExperimentConfig, run_experiment  # noqa: E402
from repro_torch.runtime.simulator import SimConfig  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    cfg = ExperimentConfig(
        dataset="tiny", n_train=2000, n_test=400, model="mlp",
        dirichlet_alpha=0.5,
        fl=FLConfig(algorithm="seafl", n_clients=20, concurrency=10,
                    buffer_size=5, staleness_limit=10.0,
                    alpha=3.0, mu=1.0, theta=0.8,   # paper Fig. 4 optimum
                    local_epochs=3, local_lr=0.1, batch_size=32, seed=0),
        sim=SimConfig(speed_model="zipf", seed=0),
        seed=0, device=args.device,
    )
    sim, hist = run_experiment(cfg, max_rounds=40, target_acc=0.55)
    print(f"{'round':>6} {'sim_time(s)':>12} {'staleness':>10} {'acc':>6}")
    for h in hist:
        print(f"{h['round']:6d} {h['time']:12.1f} {h['staleness_max']:10.0f} "
              f"{h.get('acc', float('nan')):6.3f}")
    t = sim.time_to_accuracy(0.55)
    print(f"\nSEAFL reached 55% accuracy in {t:.0f} simulated seconds "
          f"({sim.server.total_aggregations} aggregations) on "
          f"{args.device}.")


if __name__ == "__main__":
    main()
