"""Host-side helpers of the CLIs, the sequence helpers of the JAX
package's ``utils/text.py`` and the analytic FLOP model
(``utils/flops.py``)."""

from .text import intersperse, shift_1d  # noqa: F401
