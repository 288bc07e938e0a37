"""Figures from the distance matrices (a copy of ``simka_tpu.viz``)."""

from simka_tpu_torch.viz.visualize import (  # noqa: F401
    load_distance_matrix,
    plot_dendrogram,
    plot_heatmap,
    plot_pcoa,
    run_visualization,
)
