"""The Dassl zoo's trainers (counterpart of fsvlm_tpu.trainers.zoo): the
domain generalization family (dg.py); the DA and SSL families are not
ported yet (ROADMAP A9).  Importing the package registers them."""

from . import dg  # noqa: F401
