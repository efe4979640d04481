"""Host-side streaming runtime of the port: the chunked receiver chain."""

from .chain import ChainStats, DecodedPacket, ReceiverChain  # noqa: F401
