"""Pure-Python oracle codec pieces (the host verifier of the port)."""

from flacx_torch.oracle.decoder import decode_stream, read_frame

__all__ = ["decode_stream", "read_frame"]
