"""Plain PyTorch version of the SSD chunked scan (K5): the CPU path of the
wrapper in ``ops.py`` and the yardstick the CUDA kernel is held against.
It is ``repro_torch.nn.ssd.ssd_chunked`` (the port of the reference's
oracle ``repro.nn.ssd.ssd_chunked``), which also returns the final state."""

from repro_torch.nn.ssd import ssd_chunked


def ssd_reference(x, dt, A, B, C, *, chunk=128):
    """(y, final_state) of the chunked scan, both as ``ssd_chunked``."""
    return ssd_chunked(x, dt, A, B, C, chunk=chunk)
