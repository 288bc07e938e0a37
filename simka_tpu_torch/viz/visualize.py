"""Distance-matrix visualization: heatmap, dendrogram, PCoA (MDS).

The port's copy of ``simka_tpu.viz.visualize`` (host code: numpy,
matplotlib, scipy), held against the original by
tests/test_torch_host.py. Python/matplotlib replacement for the
reference Simka's R scripts (scripts/visualization/: heatmap.r,
dendro.r, pca.r, driven by run-visualization.py). Same inputs (the
csv[.gz] matrices + optional ;-separated metadata table) and same
figure kinds:

- heatmap: distance matrix with hierarchical-clustering row order
- tree: average-linkage dendrogram (R hclust default used by dendro.r)
- pca: classical MDS / PCoA on the symmetrized matrix (R cmdscale,
  pca.r:19-25)
"""

from __future__ import annotations

import glob
import gzip
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from scipy.cluster import hierarchy  # noqa: E402
from scipy.spatial.distance import squareform  # noqa: E402


def load_distance_matrix(path: str) -> Tuple[List[str], np.ndarray]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    ids = lines[0].split(";")[1:]
    mat = np.array(
        [[float(v) for v in ln.split(";")[1:]] for ln in lines[1:]]
    )
    # symmetrize like the R scripts (they mirror the upper triangle)
    iu = np.triu_indices_from(mat, 1)
    mat[(iu[1], iu[0])] = mat[iu]
    return ids, mat


def load_metadata(
    path: str, variable: str
) -> Dict[str, str]:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    header = lines[0].split(";")
    col = header.index(variable)
    out = {}
    for ln in lines[1:]:
        parts = ln.split(";")
        out[parts[0]] = parts[col]
    return out


def _group_colors(ids, metadata):
    if not metadata:
        return None, None
    groups = [metadata.get(i, "?") for i in ids]
    uniq = sorted(set(groups))
    cmap = plt.get_cmap("tab10")
    colors = [cmap(uniq.index(g) % 10) for g in groups]
    return colors, {g: cmap(uniq.index(g) % 10) for g in uniq}


def _linkage(mat: np.ndarray):
    cond = squareform(np.maximum(mat, mat.T), checks=False)
    return hierarchy.linkage(cond, method="average")


def plot_heatmap(ids, mat, out_path, metadata=None, figsize=(7, 7)):
    link = _linkage(mat) if len(ids) > 2 else None
    order = (
        hierarchy.leaves_list(link) if link is not None else np.arange(len(ids))
    )
    m = mat[np.ix_(order, order)]
    labels = [ids[i] for i in order]
    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(m, cmap="viridis", vmin=0)
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ax.set_yticklabels(labels, fontsize=7)
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title(os.path.basename(out_path).split(".")[0])
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def plot_dendrogram(ids, mat, out_path, metadata=None, figsize=(7, 7)):
    if len(ids) < 3:
        return
    link = _linkage(mat)
    colors, legend = _group_colors(ids, metadata)
    fig, ax = plt.subplots(figsize=figsize)
    dn = hierarchy.dendrogram(link, labels=ids, ax=ax)
    if colors is not None:
        id_to_color = dict(zip(ids, colors))
        for lbl in ax.get_xmajorticklabels():
            lbl.set_color(id_to_color.get(lbl.get_text(), "black"))
    ax.set_title(os.path.basename(out_path).split(".")[0])
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def pcoa(mat: np.ndarray, n_axes: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Classical MDS (R cmdscale): double-centered -D^2/2 eigenvectors."""
    d2 = np.asarray(mat, np.float64) ** 2
    n = d2.shape[0]
    J = np.eye(n) - np.ones((n, n)) / n
    B = -0.5 * J @ d2 @ J
    w, v = np.linalg.eigh(B)
    idx = np.argsort(w)[::-1]
    w, v = w[idx], v[:, idx]
    pos = np.maximum(w, 0)
    coords = v * np.sqrt(pos)[None, :]
    explained = np.where(pos.sum() > 0, pos / pos.sum(), 0.0)
    return coords[:, :n_axes], explained[:n_axes]


def plot_pcoa(
    ids, mat, out_path, metadata=None, axes=(1, 2), figsize=(7, 7)
):
    coords, expl = pcoa(mat, max(axes))
    a1, a2 = axes[0] - 1, axes[1] - 1
    colors, legend = _group_colors(ids, metadata)
    fig, ax = plt.subplots(figsize=figsize)
    ax.scatter(
        coords[:, a1],
        coords[:, a2],
        c=colors if colors is not None else "tab:blue",
    )
    for i, name in enumerate(ids):
        ax.annotate(name, (coords[i, a1], coords[i, a2]), fontsize=7)
    ax.set_xlabel(f"MDS{axes[0]} ({expl[a1] * 100:.1f}%)")
    ax.set_ylabel(f"MDS{axes[1]} ({expl[a2] * 100:.1f}%)")
    if legend:
        handles = [
            plt.Line2D([], [], marker="o", ls="", color=c, label=g)
            for g, c in legend.items()
        ]
        ax.legend(handles=handles, fontsize=7)
    ax.set_title(os.path.basename(out_path).split(".")[0])
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def run_visualization(
    input_dir: str,
    output_dir: str,
    heatmap: bool = True,
    tree: bool = True,
    pca: bool = True,
    metadata_filename: Optional[str] = None,
    metadata_variable: Optional[str] = None,
    pca_axes=(1, 2),
    fmt: str = "png",
    figsize=(7, 7),
) -> List[str]:
    """Figure generation over every matrix in a result directory
    (the role of run-visualization.py)."""
    os.makedirs(output_dir, exist_ok=True)
    metadata = (
        load_metadata(metadata_filename, metadata_variable)
        if metadata_filename
        else None
    )
    out = []
    files = sorted(
        glob.glob(os.path.join(input_dir, "mat_*.csv"))
        + glob.glob(os.path.join(input_dir, "mat_*.csv.gz"))
    )
    for path in files:
        stem = os.path.basename(path).split(".")[0]
        ids, mat = load_distance_matrix(path)
        if heatmap:
            p = os.path.join(output_dir, f"heatmap_{stem}.{fmt}")
            plot_heatmap(ids, mat, p, metadata, figsize)
            out.append(p)
        if tree:
            p = os.path.join(output_dir, f"dendro_{stem}.{fmt}")
            plot_dendrogram(ids, mat, p, metadata, figsize)
            out.append(p)
        if pca:
            p = os.path.join(output_dir, f"pca_{stem}.{fmt}")
            plot_pcoa(ids, mat, p, metadata, pca_axes, figsize)
            out.append(p)
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="simka-tpu-torch-visualization")
    p.add_argument("-in", dest="input_dir", required=True)
    p.add_argument("-out", dest="output_dir", required=True)
    p.add_argument("-heatmap", action="store_true")
    p.add_argument("-tree", action="store_true")
    p.add_argument("-pca", action="store_true")
    p.add_argument("-pca-axis-1", type=int, default=1)
    p.add_argument("-pca-axis-2", type=int, default=2)
    p.add_argument("-metadata-in", dest="metadata_in", default=None)
    p.add_argument("-metadata-variable", dest="metadata_var", default=None)
    p.add_argument("-width", type=float, default=7)
    p.add_argument("-height", type=float, default=7)
    p.add_argument("-format", default="png", choices=("png", "pdf"))
    a = p.parse_args(argv)
    any_fig = a.heatmap or a.tree or a.pca
    run_visualization(
        a.input_dir,
        a.output_dir,
        heatmap=a.heatmap or not any_fig,
        tree=a.tree or not any_fig,
        pca=a.pca or not any_fig,
        metadata_filename=a.metadata_in,
        metadata_variable=a.metadata_var,
        pca_axes=(a.pca_axis_1, a.pca_axis_2),
        fmt=a.format,
        figsize=(a.width, a.height),
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
