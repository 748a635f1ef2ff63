"""device.launches_per_frame: kernel launch calls (cudaLaunchKernel,
cudaLaunchKernelExC, cuLaunchKernel, cuLaunchKernelEx) in the profiled
segment over the frames handed in during it."""


def read(data):
    dev = data["device"]
    if dev is None or dev.launches == 0 or dev.frames == 0:
        return None
    return dev.launches / dev.frames
