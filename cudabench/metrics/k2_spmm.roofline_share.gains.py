"""k2_spmm.roofline_share.gains: percent of its roofline that the SpMM
kernel K2 (ops/spmm_kernel.py, csrc/spmm_tile.cu) reaches in the traced
slice (one whole DRE step): the mean least time of the matrix-free
saddle's sparse products over the mean device time of a K2 call.

The products are the program's counter solvers/ns_inverse.py
sparse_calls, by (rows, cols, nnz, width, bytes an element), counted
where the algorithm asks for a product (whichever kernel serves it),
process-wide: every DRE step of the cell is the same work. The least
time of one is roofline.bound_s of e (nnz + (rows + cols) width) bytes,
for e bytes an element: the matrix's values once, X in and Y out (the
kernel's index tables are its implementation's and are not counted),
and 2 nnz width operations at the peak of the elements' precision. A
K2 call's mean device time is the device time of the kernels whose name
holds "spmm" over the calls counted by spmm_kernel.launches in the
slice. Moves dre_device_ms_per_step. None where the slice has no K2
kernel or the program no such counter."""
import roofline

DTYPES = {4: "float32", 8: "float64"}  # bytes an element: precision


def read(ctx):
    from optconpy_tpu_torch.solvers import ns_inverse

    tr = ctx.trace
    calls = tr.counters.get("k2_launches", 0)
    t, n = tr.device_seconds(lambda name: "spmm" in name)
    counted = getattr(ns_inverse, "sparse_calls", None)
    if (not counted or calls == 0 or n == 0 or t <= 0
            or any(key[-1] not in DTYPES for key in counted)):
        return None
    least = sum(c * roofline.bound_s(esize * (nnz + (rows + cols) * width),
                                     2.0 * nnz * width, DTYPES[esize])[0]
                for (rows, cols, nnz, width, esize), c in counted.items())
    return 100.0 * (least / sum(counted.values())) / (t / calls)
