"""Graph components of the port: the bandit routers.

Counterpart of ``seldon_core_tpu/components/`` (the reference's
``components/`` tree, SURVEY.md §2 #37-38). Their state is a dict of
arrays, snapshotted by :mod:`seldon_core_tpu_torch.persistence`. The JAX
package's outlier detectors, drift, explainer and anchors are not ported
yet.
"""

from .routers import BanditState, EpsilonGreedy, ThompsonSampling  # noqa: F401
