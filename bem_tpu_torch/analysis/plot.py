"""Model-comparison scatter plot (counterpart of bem_tpu/analysis/plot.py;
reference: analysis/plot.py). matplotlib is imported at the call, as in
bem_tpu, so the package needs it only to plot."""

from __future__ import annotations

from typing import Dict, Sequence


def psnr_vs_flops_scatter(models: Sequence[Dict], out_path: str = "psnr_flops.png",
                          xkey: str = "flops", ykey: str = "psnr",
                          label_key: str = "name"):
    """models: [{'name', 'flops' (G), 'psnr' (dB), 'params' (M, optional)}];
    the marker's area grows with params where given (the reference's bubble
    plot). Writes ``out_path`` (150 dpi) and returns it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for m in models:
        ax.scatter(m[xkey], m[ykey], s=40 + 20 * m.get("params", 1.0), alpha=0.7)
        ax.annotate(m[label_key], (m[xkey], m[ykey]), textcoords="offset points",
                    xytext=(6, 4), fontsize=9)
    ax.set_xlabel("FLOPs (G)")
    ax.set_ylabel("PSNR (dB)")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
