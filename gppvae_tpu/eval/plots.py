"""Loss-history plots (reference: callbacks.py history panels, SURVEY.md §5).

Renders the metrics JSONL stream into the reference-style per-run history
figure: loss terms, out-of-sample MSE, and sec/epoch.
"""

from __future__ import annotations

import json
import os


def plot_history(metrics_path: str, out_path: str | None = None) -> str:
    from gppvae_tpu.utils.deps import optional_import

    optional_import("matplotlib", "plotting").use("Agg")
    plt = optional_import("matplotlib.pyplot", "plotting")

    records = []
    with open(metrics_path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if not records:
        raise ValueError(f"{metrics_path}: no records")

    out_path = out_path or os.path.join(os.path.dirname(metrics_path), "history.png")
    epochs = [r.get("epoch", i) for i, r in enumerate(records)]

    panels = [
        ("loss terms", ["loss", "recon_term", "gp_term", "kl_term", "pen_term"], "log"),
        ("error", ["mse", "oos_mse", "val_mse"], "log"),
        ("GP variances", ["v_sig", "v_noise"], "linear"),
        ("sec/epoch", ["sec_epoch"], "linear"),
    ]
    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 3))
    for ax, (title, keys, scale) in zip(axes, panels):
        for k in keys:
            ys = [(e, r[k]) for e, r in zip(epochs, records) if k in r]
            if ys:
                ax.plot([p[0] for p in ys], [p[1] for p in ys], label=k, lw=1)
        ax.set_title(title)
        ax.set_xlabel("epoch")
        if scale == "log":
            ax.set_yscale("symlog")
        if ax.get_legend_handles_labels()[1]:  # no-labels legend() warns
            ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Plot a run's metrics.jsonl")
    p.add_argument("metrics", help="path to metrics.jsonl (or its outdir)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    path = args.metrics
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    print(plot_history(path, args.out))


if __name__ == "__main__":
    main()
