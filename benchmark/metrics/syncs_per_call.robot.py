"""syncs_per_call.robot (syncs/call): calls of the CUDA runtime or driver that
make the host wait for the device, per request of the profiled stretch: the
synchronizes (stream, device, event), the blocking `cudaMemcpy`, and the
copies to pageable host memory, which return only once done. A `.cpu()` or
`.item()` of a device tensor is such a copy and a stream synchronize: it
reads 2."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


def blocking(name: str, device_name: str) -> bool:
    if name in SYNCS:
        return True
    return name.startswith(("cudaMemcpy", "cuMemcpy")) and "DtoH" in device_name \
        and "Pageable" in device_name


def read(ctx):
    if ctx.trace is None or ctx.trace.calls <= 0 or not ctx.trace.runtime:
        return None
    return ctx.trace.runtime_count(blocking) / ctx.trace.calls
