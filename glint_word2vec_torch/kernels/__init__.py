"""Building and loading the port's hand-written CUDA kernels."""


def launch_counts() -> dict:
    """Each kernel wrapper's launch counter, by wrapper name: the count a
    process reports after a run (the gang's ranks write it into their
    metrics files). The counters move only where a wrapper launches its
    kernel on the card."""
    from glint_word2vec_torch.ops import fused_sgns as fs
    from glint_word2vec_torch.ops import rows

    return {f.__name__: int(f.launches) for f in (
        rows.gather_rows, rows.scatter_add_rank1, rows.scatter_add_rows,
        fs.pair_forward, fs.pair_forward_tiled, fs.pair_forward_shared,
        fs.scatter_add_rows_f32, fs.scatter_add_rank1_hbm,
    )}
