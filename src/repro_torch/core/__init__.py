"""NL-DPE core numerics of the port (ACAM tables, log-domain DMMul and
softmax, A-SL crossbar programming, the NLDPEConfig dispatcher)."""
from .engine import FUSED, NLDPEConfig, OFF, ON
