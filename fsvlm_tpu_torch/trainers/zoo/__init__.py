"""The Dassl zoo's trainers (counterpart of fsvlm_tpu.trainers.zoo): the
domain generalization family (dg.py) and the domain adaptation family
(da.py); the five semi-supervised trainers (SupBaseline, EntMin,
MeanTeacher, MixMatch, FixMatch) are not ported yet (ROADMAP A9).
Importing the package registers them."""

from . import da, dg  # noqa: F401
