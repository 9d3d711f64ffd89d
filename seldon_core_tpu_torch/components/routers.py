"""Multi-armed-bandit routers (ROUTER graph nodes).

Counterpart of ``seldon_core_tpu/components/routers.py`` (pure numpy, so
the port keeps its own copy): behavioural counterparts of the reference's
``components/routers/epsilon-greedy/EpsilonGreedy.py`` and
``components/routers/thompson-sampling/ThompsonSampling.py``. Rewards are
Bernoulli; a feedback call carries the *mean* reward for a batch of rows,
and the router converts it to (successes, failures) =
(int(reward*n), n - int(reward*n)) before updating the chosen arm.

The bandit state is a flat dict of numpy arrays
(:meth:`BanditState.to_state_dict`), which the port's
:mod:`seldon_core_tpu_torch.persistence` writes as ``.npz`` and restores,
and the route/update rules are functions of (state, rng): for the same
seed and feedback the port routes exactly as the JAX package does.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from ..user_model import SeldonComponent

logger = logging.getLogger(__name__)


class BanditState:
    """Per-arm sufficient statistics for a Bernoulli bandit.

    ``success[i]`` / ``tries[i]`` fully determine both the empirical value
    (epsilon-greedy) and the Beta posterior ``Beta(1+success, 1+failures)``
    (Thompson sampling), so one state type serves both policies.
    """

    __slots__ = ("success", "tries", "best_branch")

    def __init__(self, n_branches: int, best_branch: int = 0):
        self.success = np.zeros(n_branches, dtype=np.float64)
        self.tries = np.zeros(n_branches, dtype=np.float64)
        self.best_branch = int(best_branch)

    @property
    def n_branches(self) -> int:
        return int(self.success.shape[0])

    @property
    def values(self) -> np.ndarray:
        """Empirical mean reward per arm (0 where untried)."""
        return np.divide(
            self.success,
            self.tries,
            out=np.zeros_like(self.success),
            where=self.tries > 0,
        )

    def update(self, branch: int, n_success: int, n_failures: int, rng) -> None:
        """Credit one feedback batch to ``branch`` and re-elect the best arm
        (ties broken uniformly at random, as in the reference)."""
        self.success[branch] += n_success
        self.tries[branch] += n_success + n_failures
        vals = self.values
        ties = np.flatnonzero(vals == vals.max())
        self.best_branch = int(rng.choice(ties))

    # --- pytree-ish accessors for persistence -------------------------------
    def to_state_dict(self) -> Dict[str, np.ndarray]:
        return {
            "success": self.success,
            "tries": self.tries,
            "best_branch": np.asarray(self.best_branch),
        }

    def from_state_dict(self, d: Dict[str, np.ndarray]) -> None:
        self.success = np.asarray(d["success"], dtype=np.float64)
        self.tries = np.asarray(d["tries"], dtype=np.float64)
        self.best_branch = int(np.asarray(d["best_branch"]))


def _batch_to_success_failures(X, reward: float):
    """reward = mean Bernoulli reward over the batch → integer counts."""
    n = int(np.asarray(X).shape[0]) if np.ndim(X) >= 1 else 1
    n_success = int(float(reward) * n)
    return n_success, n - n_success


class _BanditRouter(SeldonComponent):
    """Shared plumbing: parameter parsing, history, state accessors."""

    def __init__(
        self,
        n_branches=None,
        seed=None,
        history=False,
        branch_names: Optional[str] = None,
        verbose=False,
    ):
        if verbose:
            logger.setLevel(logging.DEBUG)
        n_branches = int(n_branches)
        if n_branches <= 0:
            raise ValueError(f"n_branches must be positive, got {n_branches}")
        self.rng = np.random.default_rng(None if seed is None else int(seed))
        self.history = bool(history)
        self.branch_history: List[int] = []
        self.value_history: List[np.ndarray] = []
        self.branch_names = (
            branch_names.split(":") if isinstance(branch_names, str) else None
        )
        self.state = BanditState(n_branches)

    def _record(self, branch: int) -> None:
        if self.history:
            self.branch_history.append(branch)
            self.value_history.append(self.state.values.copy())

    def send_feedback(self, X, names, reward, truth, routing=None):
        if routing is None:
            return
        n_success, n_failures = _batch_to_success_failures(X, reward)
        self._update(int(routing), n_success, n_failures)

    def _update(self, branch: int, n_success: int, n_failures: int) -> None:
        self.state.update(branch, n_success, n_failures, self.rng)

    def tags(self) -> Dict:
        name = (
            self.branch_names[self.state.best_branch]
            if self.branch_names
            else self.state.best_branch
        )
        return {"best_branch": name}

    def metrics(self) -> List[Dict]:
        return [
            {
                "type": "GAUGE",
                "key": f"branch_{i}_value",
                "value": float(v),
            }
            for i, v in enumerate(self.state.values)
        ]

    # persistence hooks (seldon_core_tpu_torch.persistence)
    def to_state_dict(self) -> Dict:
        return self.state.to_state_dict()

    def from_state_dict(self, d: Dict) -> None:
        self.state.from_state_dict(d)


class EpsilonGreedy(_BanditRouter):
    """Route to the empirically-best arm w.p. 1-epsilon, else a uniform other arm.

    Parameters mirror the reference component: n_branches, epsilon,
    best_branch (optional starting arm), seed, history, branch_names, verbose.
    """

    def __init__(
        self,
        n_branches=None,
        epsilon=0.1,
        best_branch=None,
        seed=None,
        history=False,
        branch_names=None,
        verbose=False,
    ):
        super().__init__(n_branches, seed, history, branch_names, verbose)
        self.epsilon = float(epsilon)
        self.state.best_branch = (
            int(best_branch)
            if best_branch is not None
            else int(self.rng.integers(self.state.n_branches))
        )

    def route(self, X, names, meta=None) -> int:
        best = self.state.best_branch
        if self.state.n_branches > 1 and self.rng.random() <= self.epsilon:
            others = [i for i in range(self.state.n_branches) if i != best]
            branch = int(self.rng.choice(others))
        else:
            branch = best
        self._record(branch)
        return branch


class ThompsonSampling(_BanditRouter):
    """Beta-Bernoulli Thompson sampling: sample Beta(1+s_i, 1+f_i) per arm,
    route to the argmax. Prior is Beta(1,1) (uniform), as in the reference."""

    def route(self, X, names, meta=None) -> int:
        alpha = 1.0 + self.state.success
        beta = 1.0 + (self.state.tries - self.state.success)
        samples = self.rng.beta(alpha, beta)
        branch = int(np.argmax(samples))
        self._record(branch)
        return branch
