"""fun_ofdm_tpu_torch: the 802.11a OFDM PHY of fun_ofdm_tpu, in PyTorch.

The port runs the dense capture receive (TX frame build, then frame
detection and decode), the header-driven dynamic and any-rate decoders and
the streaming receiver chain (`runtime.chain.ReceiverChain`) on an NVIDIA
H100, with a hand-written CUDA Viterbi (`csrc/viterbi.cu`: the exact
decode and the block-overlap decode). Its modules mirror fun_ofdm_tpu's
(`ops/`, `models/`, `runtime/`, `utils/`); fun_ofdm_tpu is the reference
it is tested against.

The rate table, the preamble and the chain configuration are plain
Python/numpy modules; the port re-exports them so that both packages share
one `Rate` enum. Importing this package imports no jax, builds nothing and
needs no GPU.
"""

from .rates import Rate, RateParams, params_for, from_rate_field  # noqa: F401
from .config import ChainParams, DEFAULT_PARAMS  # noqa: F401

__version__ = "0.1.0"
