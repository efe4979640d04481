"""RX chain configuration, shared with fun_ofdm_tpu (stdlib only)."""

from fun_ofdm_tpu.config import DEFAULT_PARAMS, ChainParams  # noqa: F401
