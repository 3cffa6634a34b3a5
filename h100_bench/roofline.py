"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, 700 W):
HBM3 bandwidth and the float32 rate outside the tensor cores (the kernels of
the program use no tensor core). A kernel's bound is the larger of its bytes
over the bandwidth and its operations over the rate; its roofline share is
that bound over the device time it took. The operations and bytes of each
kernel are counted in its metric's file under ``layers/``."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def share_pct(bound_total_s: float, device_s: float):
    """Bound over device time, in %; None where the kernel did not run."""
    if device_s <= 0:
        return None
    return 100.0 * bound_total_s / device_s
