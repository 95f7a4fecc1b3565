"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its full 700 W power limit): the benchmark's roofline and MFU are
shares of these. Frozen here so that no change to the program moves them.
"""
#: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: float32 operations per second outside the tensor cores (the sweep runs
#: full float32: TF32 is off)
FP32_FLOP_PER_S = 67e12
