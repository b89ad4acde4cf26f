"""The Dassl zoo's trainers (counterpart of fsvlm_tpu.trainers.zoo): the
domain generalization family (dg.py), the domain adaptation family
(da.py) and the semi-supervised family (ssl.py).  Importing the package
registers them."""

from . import da, dg, ssl  # noqa: F401
