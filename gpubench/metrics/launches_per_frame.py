"""``launches_per_frame`` (launches, layer: host prep): the CUDA
kernel-launch calls the traced window made, runtime and driver API alike,
per frame rendered. Moves ``frames_per_s``."""

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def read(t):
    n = len(t.clip(t.runtime_calls(LAUNCH_CALLS)))
    if not n or not t.frames:
        return None
    return n / t.frames
