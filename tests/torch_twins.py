"""Helper of the port's parity tests: the JAX package's twin of a model.

The tests build each model once, with the port's classes, and hand the
JAX package's code only the twin made here; no test hands a
``datok_tpu`` object to the port.
"""

import copy

from datok_tpu.fsa.double_array import DaTokenizer as JaxDaTokenizer
from datok_tpu.fsa.matrix import MatrixTokenizer as JaxMatrixTokenizer


def jax_twin(tok):
    """The JAX package's tokenizer holding a copy of every field of the
    port's ``tok`` (arrays, scalars, sigma, and a synthetic model's
    ``abbrevs``)."""
    twin = (JaxMatrixTokenizer if tok.type() == "MATOK" else JaxDaTokenizer)()
    for name, value in vars(tok).items():
        setattr(twin, name, copy.deepcopy(value))
    return twin
