"""Channel simulator and BER/PER harness of the port."""

from . import ber, channel  # noqa: F401
