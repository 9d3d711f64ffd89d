"""Graph components of the port: the bandit routers, the outlier
detectors (``outlier``), the KS drift detector, and the explainer
(``explainer.Explainer``: ``/explain``) with its anchors.

Counterpart of ``seldon_core_tpu/components/`` (the reference's
``components/`` tree, SURVEY.md §2 #37-38). Their state is a dict of
arrays, snapshotted by :mod:`seldon_core_tpu_torch.persistence`.
"""

from .drift import KSDrift  # noqa: F401
from .routers import BanditState, EpsilonGreedy, ThompsonSampling  # noqa: F401
