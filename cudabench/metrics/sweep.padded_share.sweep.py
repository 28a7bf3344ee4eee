"""sweep.padded_share.sweep: percent of the sweep's computed
scenario-columns that are padding, from the program's layout counters
(parallel/param_sweep.py layout_padded_columns over layout_real_columns
plus layout_padded_columns, summed over sweep_layout's calls,
process-wide): the work that masked rows cost every step. Moves
closed_loop_solves_per_s. None where the program has no such counters
or laid out no sweep."""


def read(ctx):
    from optconpy_tpu_torch.parallel import param_sweep

    real = getattr(param_sweep, "layout_real_columns", None)
    padded = getattr(param_sweep, "layout_padded_columns", None)
    if real is None or padded is None or real + padded == 0:
        return None
    return 100.0 * padded / (real + padded)
