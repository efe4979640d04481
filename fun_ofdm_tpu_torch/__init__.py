"""fun_ofdm_tpu_torch: the 802.11a OFDM PHY of fun_ofdm_tpu, in PyTorch.

The port runs the dense capture receive (TX frame build, then frame
detection and decode), the header-driven dynamic and any-rate decoders,
CFO correction, the streaming receiver chain (`runtime.chain.ReceiverChain`)
and the channel simulator with its BER/PER harness (`sim`) on an NVIDIA
H100, with a hand-written CUDA Viterbi (`csrc/viterbi.cu`: the exact
decode, the block-overlap decode, and the ACS ablation variants of the A/B
harness `tools.viterbi_acs_ab`). Its modules mirror fun_ofdm_tpu's
(`ops/`, `models/`, `runtime/`, `sim/`, `utils/`); fun_ofdm_tpu is the
reference it is tested against.

The rate table, the preamble, the chain configuration, the wire formats
and the native chunker are the port's own copies of fun_ofdm_tpu's; `Rate`
is an IntEnum with the same values, so rates of the two packages compare
equal. Importing this package imports neither jax nor anything of
fun_ofdm_tpu, builds nothing and needs no GPU.
"""

from .rates import Rate, RateParams, params_for, from_rate_field  # noqa: F401
from .config import ChainParams, DEFAULT_PARAMS  # noqa: F401

__version__ = "0.1.0"
