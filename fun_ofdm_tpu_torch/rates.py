"""802.11a MCS rate table, shared with fun_ofdm_tpu (stdlib only)."""

from fun_ofdm_tpu.rates import (  # noqa: F401
    ALL_RATES,
    RATE_PARAMS,
    VALID_RATE_FIELDS,
    Rate,
    RateParams,
    from_rate_field,
    params_for,
)
