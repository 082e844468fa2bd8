"""The least time each hand-written kernel of the program could take on
one H100, from the work its call's shapes and data need.

A frozen copy of ``chip_smoke.py``'s counts (PR 3-16): bytes are every
input read once and every output written once (``frame_pack`` and
``crc16_rows`` count what they must move, as there); operations are
counted by type and each type runs at its peak.  The bound of a call is
the larger of its bytes at the HBM rate and the sum of its operations'
times.  :func:`bound_s` takes a kernel wrapper's name, its positional
arguments as the program passed them, and its outputs.

Peaks: NVIDIA's H100 SXM data sheet (dense, 700 W): HBM 3.35 TB/s, the
int8 tensor cores 1979 TOP/s, 67 TFLOP/s outside the tensor cores (each
scalar ALU operation counted at that rate); f64 instructions at 64 a
clock an SM (132 SMs, 1.98 GHz).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
SCALAR_OPS_PER_S = 67e12
F64_OPS_PER_S = 64 * 132 * 1.98e9

KIND_VERBATIM, KIND_FIXED = 1, 2

#: the hand kernels: wrapper name → the kernel names it launches (as
#: the profiler's trace shows them, matched as substrings)
KERNELS = {
    "analysis": ("analysis_kernel",),
    "lpc_residual_stats": ("lpc_residual_kernel",),
    "lpc_residual_zz": ("lpc_residual_kernel",),
    "lpc_residual_res": ("lpc_residual_kernel",),
    "lpc_allorder": ("lpc_allorder_kernel",),
    "rice_stats": ("rice_stats_kernel",),
    "frame_pack": ("frame_pack_kernel",),
    "bit_unpack": ("bit_unpack_kernel",),
    "reconstruct": ("reconstruct_kernel",),
    "crc16_rows": ("crc16_rows_kernel",),
}
ENCODE = ("analysis", "lpc_residual_stats", "lpc_residual_zz",
          "lpc_residual_res", "lpc_allorder", "rice_stats", "frame_pack")
DECODE = ("bit_unpack", "reconstruct", "crc16_rows")


def is_hand_kernel(name: str, wrappers=tuple(KERNELS)) -> bool:
    """Whether a trace's kernel name is one of ``wrappers``' kernels."""
    return any(sym in name for w in wrappers for sym in KERNELS[w])


def nbytes(*items) -> int:
    """Bytes of every tensor in ``items`` (nested tuples and dicts too)."""
    total = 0
    for it in items:
        if isinstance(it, dict):
            total += nbytes(*it.values())
        elif isinstance(it, (tuple, list)):
            total += nbytes(*it)
        elif hasattr(it, "element_size"):
            total += it.numel() * it.element_size()
    return total


def mac_int32_ok(eff_bps: int, sum_taps_max: int) -> bool:
    """The int32 MAC is exact: ``eff_bps + 1 + bitlen(Σ|taps|) <= 31``."""
    return eff_bps + 1 + max(1, sum_taps_max).bit_length() <= 31


def sample_limbs(eff_bps: int) -> int:
    """8-bit limbs of a sample: 3 up to 24 bits, else 4."""
    return 3 if eff_bps <= 24 else 4


def limb_ops(n: int, taps, limbs: int) -> int:
    """An exact integer MAC as 8-bit limb products on the tensor cores:
    each row's nonzero taps (``taps [..., K]``) times its ``n`` samples,
    times ``limbs`` sample limbs and two tap limbs where a tap of the row
    passes [-128, 127], two operations a multiply-add."""
    nonzero = (taps != 0).sum(-1)
    two = ((taps < -128) | (taps > 127)).any(-1)
    return 2 * int((nonzero * (1 + two.long())).sum()) * n * limbs


def frame_pack_bytes(args) -> int:
    """What ``frame_pack`` must move: each symbol's value and length at
    4 B; per channel the samples its subframe codes (``x`` of a verbatim
    one; ``zz`` past the warm-up at its own width, ``kesc`` and the
    partition parameters of a fixed or LPC one) and its kind, order and
    width; the frame bytes and lengths written once."""
    hdr_v, sh_v, pv, zz, kesc, kind, order = (args[i] for i in
                                              (0, 2, 4, 6, 8, 9, 10))
    max_frame_bytes = args[13]
    n = zz.shape[-1]
    coded = (zz.element_size() * (n - order.long())
             + 4 * (kesc.shape[-1] + 2 * pv.shape[-1]))
    per_channel = ((kind == KIND_VERBATIM) * 4 * n
                   + (kind >= KIND_FIXED) * coded)
    return (8 * (hdr_v.numel() + sh_v.numel()) + int(per_channel.sum())
            + 12 * kind.numel() + hdr_v.shape[0] * (max_frame_bytes + 4))


def work(name: str, args: tuple, out) -> tuple[int, list]:
    """``(bytes, [(operations, rate), ...])`` of one call."""
    moved = nbytes(args, out)
    if name == "analysis":
        x, window, max_lag = args[:3]
        eff_bps = args[3] if len(args) > 3 else 32
        fixed_ops = 26 * (2 if eff_bps > 26 else 1)
        n = x.shape[-1]
        rows = x[..., 0].numel()
        windowed = rows * n * (window.shape[0] if window.dim() > 1 else 1)
        adds = windowed * (max_lag + 1)
        if window.element_size() == 8:
            return moved, [(2 * adds + windowed, F64_OPS_PER_S)]
        return moved, [(adds, F64_OPS_PER_S),
                       (adds + windowed + rows * n * fixed_ops,
                        SCALAR_OPS_PER_S)]
    if name.startswith("lpc_residual"):
        xs, taps, eff_bps, taps_max = args[0], args[1], args[4], args[5]
        if not mac_int32_ok(eff_bps, taps_max):
            return moved, [(limb_ops(xs.shape[-1], taps,
                                     sample_limbs(eff_bps)),
                            INT8_TENSOR_OPS_PER_S),
                           (xs.numel() * 12, SCALAR_OPS_PER_S)]
        return moved, [(2 * int((taps != 0).sum()) * xs.shape[-1]
                        + xs.numel() * 6, SCALAR_OPS_PER_S)]
    if name == "lpc_allorder":
        x, qcoefs, eff_bps, taps_max = args[0], args[1], args[3], args[4]
        wide = not mac_int32_ok(eff_bps, taps_max)
        epilogue = x.numel() * qcoefs.shape[-2] * (16 if wide else 8)
        return moved, [(limb_ops(x.shape[-1], qcoefs.flatten(-2),
                                 sample_limbs(eff_bps)),
                        INT8_TENSOR_OPS_PER_S),
                       (epilogue, SCALAR_OPS_PER_S)]
    if name == "rice_stats":
        zz, kmax = args[0], args[3]
        return moved, [(zz.numel() * (2 * (kmax + 1) + 1),
                        SCALAR_OPS_PER_S)]
    if name == "frame_pack":
        xs = args[7]
        return frame_pack_bytes(args), [
            (xs.numel() * 30 + xs.shape[0] * args[13] * 4,
             SCALAR_OPS_PER_S)]
    if name == "bit_unpack":
        kind, order, n = args[5].long(), args[6].long(), args[9]
        symbols = int(((kind == 1) * n + (kind >= 2) * (n - order)).sum())
        return moved, [(40 * symbols, SCALAR_OPS_PER_S)]
    if name == "reconstruct":
        vals, order, kind, use_i32 = args[0], args[3], args[4], args[12]
        macs = int((order.long() * (kind >= 2)).sum()) * vals.shape[-1]
        return moved, [(macs * (2 if use_i32 else 4) + vals.numel() * 8,
                        SCALAR_OPS_PER_S)]
    if name == "crc16_rows":
        lens = args[1]
        body = int(lens.long().sum())
        return body + 8 * lens.numel() + 4, [(3 * body, SCALAR_OPS_PER_S)]
    raise KeyError(f"no count for kernel wrapper {name!r}")


def bound_s(name: str, args: tuple, out) -> float:
    """The least seconds of one call: bytes or operations, the larger."""
    moved, ops = work(name, args, out)
    return max(moved / HBM_BYTES_PER_S, sum(o / r for o, r in ops))
