"""802.11a preamble constants, shared with fun_ofdm_tpu (numpy only)."""

from fun_ofdm_tpu.preamble import (  # noqa: F401
    FFT_LEN,
    LTS1_OFFSET,
    LTS2_OFFSET,
    LTS_FREQ_DOMAIN,
    LTS_LENGTH,
    LTS_TIME_DOMAIN,
    LTS_TIME_DOMAIN_CONJ,
    PREAMBLE_LENGTH,
    PREAMBLE_SAMPLES,
    STS_FREQ_DOMAIN,
    STS_LENGTH,
    STS_TIME_DOMAIN,
    SYMBOL0_OFFSET,
    SYMBOL_STRIDE,
)
