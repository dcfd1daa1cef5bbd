"""The yardstick of the kernels: published H100 peaks and the least time
each kernel's work can take at its call's shapes.

Frozen copies of chip_smoke.py's H100_* peaks and of two_nn_bound_ms,
seg_sum_bound_ms, camera_bound_ms and smatvec_bound_ms, taking shapes and
counts instead of tensors, so that the benchmark reads the same bound
whatever the program becomes.  Each returns milliseconds.
"""

H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12    # float32 outside the tensor cores
H100_F64_FLOPS = 34e12    # float64 outside the tensor cores
H100_BYTES = 3.35e12      # HBM3 bandwidth


def two_nn_bound_ms(pair_products, D, desc_bytes, n_counts, n_pairs, out_elems, int8=True):
    """K1: 2 * sum(na * nb) * D operations (pair_products = sum na * nb)
    at the int8 tensor-core or float32 peak, against each input read once
    (descriptors, counts, pairs) and each output written once (d1, d2,
    idx1: 12 bytes an output row)."""
    ops = 2.0 * pair_products * D
    nbytes = desc_bytes + n_counts * 4 + n_pairs * 2 * 4 + out_elems * 12
    return max(ops / (H100_INT8_OPS if int8 else H100_F32_FLOPS), nbytes / H100_BYTES) * 1e3


def seg_sum_bound_ms(O, k, num, itemsize):
    """K2's generic sum: ids (4 B) and k values read once a row, (num, k)
    written once, against O * k additions outside the tensor cores."""
    nbytes = O * 4 + O * k * itemsize + num * k * itemsize
    t_ops = O * k / (H100_F32_FLOPS if itemsize == 4 else H100_F64_FLOPS)
    return max(t_ops, nbytes / H100_BYTES) * 1e3


def camera_bound_ms(O, P, I, kind, itemsize):
    """K2's fused camera sums: the J blocks (12 + 16 values a row), u (2
    values, J^T u only) and both int32 id streams read once, the outputs
    written once; bytes bound it."""
    per_row = (28 + (2 if kind == "jtu" else 0)) * itemsize + 8
    out = (P * 6 + I * 8) if kind == "jtu" else (P * 36 + I * 64)
    return (O * per_row + out * itemsize) / H100_BYTES * 1e3


def smatvec_bound_ms(O, L1, L, M, P, I):
    """K3's fused S-matvec (float32): the slot Jacobians (34 floats) and
    both ids read once a slot, the point blocks, row and group tables and
    v read once, (P, 6) and (I, 8) written once, against 68 multiply-adds
    a slot and 9 a point at the float32 rate outside the tensor cores."""
    nbytes = O * (34 * 4 + 2 * 4) + L * 9 * 4 + L1 * 4 + L * M * 4 + 2 * (P * 6 + I * 8) * 4
    t_ops = (O * 68 + L * 9) * 2 / H100_F32_FLOPS
    return max(t_ops, nbytes / H100_BYTES) * 1e3
