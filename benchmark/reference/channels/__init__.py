"""The decoding problem of each channel, one module a channel.

``check.Reference`` finds the module by the configuration's ``channel``,
with ``-`` written as ``_`` (``space-time`` is ``space_time.py``). Each
module defines ``problem(config, p) -> dict`` with

  H         the decoding matrix, (m, n) uint8
  L         the logicals that classification tests, (k, n') uint8
  prior     the draw's probability, a float32 scalar or one value a
            variable: a variable is drawn as ``u < prior``
  band      a draw within ``band`` of its prior may fall either way (0: none)
  distance  the distance of the low-weight test (0: every error is high weight)
  llr       BP's prior LLRs, float32, one a variable
  fold      (B, n) bits -> (B, n') bits that ``L`` and the weights read
"""


def identity(bits):
    """The fold of a channel whose variables are the code's qubits."""
    return bits
