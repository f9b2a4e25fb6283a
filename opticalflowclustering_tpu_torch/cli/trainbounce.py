"""Train the learned bounce classifier on labeled hue CSVs (port of
`opticalflowclustering_tpu/cli/trainbounce.py`):

  --bounce bounce.csv --nobounce nobounce.csv no_bounce2.csv \\
      [--window 9] [--steps 300] [--lr 1e-3] [--out bounce_params.npz] [--device cuda|cpu]

Windows of the bounce hue series train as positives, windows of the
no-bounce series as negatives: the supervised upgrade of the reference's
single-template cosine matching (`findCosineDifferentVectors.py`). Column 1
of each headerless CSV is the series. The saved npz has the JAX CLI's keys
(`jax.tree_util.keystr` of the flax params), so the JAX package's
BounceClassifier loads it.
"""

from __future__ import annotations

import argparse

import numpy as np


def load_hue_series(csv_path: str) -> np.ndarray:
    """Column 1 of a headerless CSV as float32."""
    from opticalflowclustering_tpu_torch.cli.findcosine import read_column

    return read_column(csv_path, 1).astype(np.float32)


def build_dataset(bounce_csvs: list[str], nobounce_csvs: list[str], window: int):
    from opticalflowclustering_tpu_torch.models.bounce_classifier import hue_windows_from_series

    xs, ys = [], []
    for paths, label in ((bounce_csvs, 1.0), (nobounce_csvs, 0.0)):
        for p in paths:
            w = hue_windows_from_series(load_hue_series(p), window)
            xs.append(w)
            ys.append(np.full(len(w), label, np.float32))
    return np.concatenate(xs), np.concatenate(ys)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bounce", nargs="+", required=True)
    ap.add_argument("--nobounce", nargs="+", required=True)
    ap.add_argument("--window", type=int, default=9)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="bounce_params.npz")
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; it raises where there is "
        "no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    import torch

    from opticalflowclustering_tpu_torch.convert import to_flax_params
    from opticalflowclustering_tpu_torch.models.bounce_classifier import train_on_hue_windows

    x, y = build_dataset(args.bounce, args.nobounce, args.window)
    print(f"dataset: {len(x)} windows ({int(y.sum())} positive)")
    model, loss = train_on_hue_windows(x, y, steps=args.steps, lr=args.lr, device=args.device)
    with torch.inference_mode():
        logits = model(torch.from_numpy(x).to(next(model.parameters()).device)).cpu().numpy()
    acc = float(((logits > 0) == (y > 0.5)).mean())
    print(f"final loss {loss:.4f}, train accuracy {acc:.3f}")
    np.savez(args.out, **to_flax_params(model))
    print(f"saved params to {args.out}")
    return model, loss


if __name__ == "__main__":
    main()
