"""Hyperparameter search (``HyperTuning``).

Counterpart of ``recbole_fairrec_tpu/trainer/hyper_tuning.py`` (numpy only
there too), copied so that the port imports nothing of the JAX package: the
same public surface (``HyperTuning(objective_function, space|params_file|
params_dict, algo, max_evals, fixed_config_file_list)``, ``.run()``,
``.export_result()``, ``best_params`` / ``params2result``), the same
params-file grammar (lines of ``<name> <type> <spec>`` with types choice /
uniform / quniform / loguniform) and the same four algorithms on the same
``np.random.RandomState(seed)`` stream, so a fixed seed gives the JAX
package's trial order:

* ``exhaustive`` — grid over choice spaces;
* ``random`` — uniform sampling of each dimension;
* ``anneal`` — simulated annealing: sample near the best observed point
  with a neighborhood that shrinks over trials, mixed with occasional
  uniform exploration;
* ``bayes`` — TPE: after a random startup phase, draw a candidate pool and
  pick the point maximizing the density ratio good-trials / bad-trials
  (Gaussian kernels on continuous dims, smoothed counts on choice dims).

Each trial is one full train+test through the objective, for the port
``quick_start.objective_function``; the trials run where its config says
(the card unless ``use_gpu: False``).
"""

from __future__ import annotations

import ast
from itertools import product
from logging import getLogger

import numpy as np

from ..utils.common import dict2str


class ExhaustiveSearchError(Exception):
    pass


class _Dim:
    """One search dimension."""

    def __init__(self, name, kind, spec):
        self.name = name
        self.kind = kind
        self.spec = spec

    def enumerate(self):
        if self.kind == "choice":
            return list(self.spec)
        raise ExhaustiveSearchError(
            "Exhaustive search is only possible with 'choice' parameters; "
            f"[{self.name}] is [{self.kind}]"
        )

    def sample(self, rng):
        if self.kind == "choice":
            return self.spec[rng.randint(len(self.spec))]
        if self.kind == "uniform":
            low, high = self.spec
            return float(rng.uniform(low, high))
        if self.kind == "quniform":
            low, high, q = self.spec
            return float(np.round(rng.uniform(low, high) / q) * q)
        if self.kind == "loguniform":
            low, high = self.spec
            return float(np.exp(rng.uniform(low, high)))
        raise ValueError(f"unknown parameter type [{self.kind}]")

    def perturb(self, value, frac, rng):
        """Neighbor of ``value`` with relative neighborhood size ``frac``
        (annealing move)."""
        if self.kind == "choice":
            if rng.rand() < max(frac, 1.0 / max(len(self.spec), 1)):
                return self.spec[rng.randint(len(self.spec))]
            return value
        if self.kind == "uniform":
            low, high = self.spec
            return float(np.clip(rng.normal(value, frac * (high - low) / 2), low, high))
        if self.kind == "quniform":
            low, high, q = self.spec
            v = np.clip(rng.normal(value, frac * (high - low) / 2), low, high)
            return float(np.round(v / q) * q)
        if self.kind == "loguniform":
            low, high = self.spec  # bounds in log space (hyperopt convention)
            lv = np.clip(rng.normal(np.log(value), frac * (high - low) / 2), low, high)
            return float(np.exp(lv))
        raise ValueError(f"unknown parameter type [{self.kind}]")

    def _numeric(self, value):
        """Map a value to the space where kernels make sense."""
        if self.kind == "choice":
            return None
        return float(np.log(value)) if self.kind == "loguniform" else float(value)

    def log_likelihood(self, value, observed):
        """Kernel density of ``value`` under the observed set (TPE)."""
        if self.kind == "choice":
            counts = {c: 1.0 for c in self.spec}  # +1 smoothing
            for o in observed:
                counts[o] = counts.get(o, 1.0) + 1.0
            total = sum(counts.values())
            return float(np.log(counts.get(value, 1.0) / total))
        x = self._numeric(value)
        obs = np.asarray([self._numeric(o) for o in observed], dtype=np.float64)
        if self.kind == "loguniform":
            low, high = self.spec
            span = high - low
        else:
            low, high = self.spec[0], self.spec[1]
            span = high - low
        bw = max(obs.std() * len(obs) ** -0.2, 0.05 * span, 1e-12)
        dens = np.exp(-0.5 * ((x - obs) / bw) ** 2).sum() / (len(obs) * bw * np.sqrt(2 * np.pi))
        return float(np.log(max(dens, 1e-300)))


class HyperTuning:
    def __init__(
        self,
        objective_function,
        space=None,
        params_file=None,
        params_dict=None,
        fixed_config_file_list=None,
        algo="exhaustive",
        max_evals=100,
        seed=2020,
    ):
        self.best_score = None
        self.best_params = None
        self.best_test_result = None
        self.params2result = {}
        self.logger = getLogger()

        self.objective_function = objective_function
        self.max_evals = max_evals
        self.fixed_config_file_list = fixed_config_file_list
        self.seed = seed

        if space:
            self.space = space
        elif params_file:
            self.space = self._build_space_from_file(params_file)
        elif params_dict:
            self.space = self._build_space_from_dict(params_dict)
        else:
            raise ValueError("at least one of `space`, `params_file` and `params_dict` should be provided")

        if isinstance(algo, str):
            if algo == "exhaustive":
                self.algo = "exhaustive"
                self.max_evals = int(
                    np.prod([len(d.enumerate()) for d in self.space.values()])
                )
            elif algo in ("random", "anneal", "bayes"):
                self.algo = algo
            else:
                raise ValueError(f"Illegal algo [{algo}]")
        else:
            self.algo = algo
        self._history = []  # (params, score, bigger) per completed trial

    # ---------------------------------------------------------------- spaces

    @staticmethod
    def _build_space_from_file(file):
        """Grammar: ``<name> <type> <spec>`` per line (reference :48-72)."""
        space = {}
        with open(file, "r") as fp:
            for line in fp:
                para_list = line.strip().split(" ")
                if len(para_list) < 3:
                    continue
                name, kind = para_list[0], para_list[1]
                value = " ".join(para_list[2:])
                if kind == "choice":
                    space[name] = _Dim(name, "choice", ast.literal_eval(value))
                elif kind in ("uniform", "loguniform"):
                    low, high = value.strip().split(" ")
                    space[name] = _Dim(name, kind, (float(low), float(high)))
                elif kind == "quniform":
                    low, high, q = value.strip().split(" ")
                    space[name] = _Dim(name, kind, (float(low), float(high), float(q)))
                else:
                    raise ValueError(f"Illegal param type [{kind}]")
        return space

    @staticmethod
    def _build_space_from_dict(config_dict):
        space = {}
        for kind, params in config_dict.items():
            if kind == "choice":
                for name, value in params.items():
                    space[name] = _Dim(name, "choice", value)
            elif kind in ("uniform", "loguniform"):
                for name, value in params.items():
                    space[name] = _Dim(name, kind, (float(value[0]), float(value[1])))
            elif kind == "quniform":
                for name, value in params.items():
                    space[name] = _Dim(
                        name, kind, (float(value[0]), float(value[1]), float(value[2]))
                    )
            else:
                raise ValueError(f"Illegal param type [{kind}]")
        return space

    # ---------------------------------------------------------------- output

    @staticmethod
    def params2str(params):
        return ", ".join(f"{name}:{value}" for name, value in params.items())

    def _print_result(self, result_dict):
        self.logger.info("current best valid score: %.4f" % result_dict["best_valid_score"])
        self.logger.info("current best valid result:")
        self.logger.info(result_dict["best_valid_result"])
        self.logger.info("current test result:")
        self.logger.info(result_dict["test_result"])

    def export_result(self, output_file=None):
        with open(output_file, "w") as fp:
            for params in self.params2result:
                fp.write(params + "\n")
                fp.write(
                    "Valid result:\n"
                    + dict2str(self.params2result[params]["best_valid_result"])
                    + "\n"
                )
                fp.write(
                    "Test result:\n"
                    + dict2str(self.params2result[params]["test_result"])
                    + "\n\n"
                )

    # ------------------------------------------------------------------ run

    def trial(self, params):
        config_dict = dict(params)
        params_str = self.params2str(params)
        self.logger.info("running parameters:")
        self.logger.info(str(config_dict))
        result_dict = self.objective_function(config_dict, self.fixed_config_file_list)
        self.params2result[params_str] = result_dict
        score, bigger = result_dict["best_valid_score"], result_dict["valid_score_bigger"]
        self._history.append((dict(params), score, bigger))

        if self.best_score is None:
            improved = True
        else:
            improved = score > self.best_score if bigger else score < self.best_score
        if improved:
            self.best_score = score
            self.best_params = params
            self.best_test_result = result_dict["test_result"]
            self._print_result(result_dict)
        return score

    def _candidates(self):
        """Lazily yields the next trial's params. The ``run`` loop executes
        each trial before pulling the next candidate, so the adaptive
        algorithms (anneal / bayes) see every completed result in
        ``self._history``."""
        if self.algo == "exhaustive":
            names = list(self.space.keys())
            grids = [self.space[n].enumerate() for n in names]
            for combo in product(*grids):
                yield dict(zip(names, combo))
        elif self.algo == "random":
            rng = np.random.RandomState(self.seed)
            for _ in range(self.max_evals):
                yield {n: d.sample(rng) for n, d in self.space.items()}
        elif self.algo == "anneal":
            rng = np.random.RandomState(self.seed)
            for i in range(self.max_evals):
                if self.best_params is None or rng.rand() < 0.3:
                    yield {n: d.sample(rng) for n, d in self.space.items()}
                else:
                    frac = max(1.0 - i / max(self.max_evals - 1, 1), 0.05)
                    yield {
                        n: d.perturb(self.best_params[n], frac, rng)
                        for n, d in self.space.items()
                    }
        elif self.algo == "bayes":
            rng = np.random.RandomState(self.seed)
            n_startup = min(10, max(self.max_evals // 3, 1))
            pool = 50
            for i in range(self.max_evals):
                if len(self._history) < n_startup:
                    yield {n: d.sample(rng) for n, d in self.space.items()}
                    continue
                # TPE: rank trials, split top-γ "good" vs rest "bad"
                bigger = self._history[0][2]
                ranked = sorted(
                    self._history, key=lambda t: t[1], reverse=bool(bigger)
                )
                n_good = max(1, int(np.ceil(0.25 * len(ranked))))
                good = [t[0] for t in ranked[:n_good]]
                bad = [t[0] for t in ranked[n_good:]] or good
                best, best_ratio = None, -np.inf
                for _ in range(pool):
                    cand = {n: d.sample(rng) for n, d in self.space.items()}
                    ratio = sum(
                        d.log_likelihood(cand[n], [g[n] for g in good])
                        - d.log_likelihood(cand[n], [b[n] for b in bad])
                        for n, d in self.space.items()
                    )
                    if ratio > best_ratio:
                        best, best_ratio = cand, ratio
                yield best
        else:  # custom callable: algo(space, rng) -> iterable of param dicts
            rng = np.random.RandomState(self.seed)
            yield from self.algo(self.space, rng)

    def run(self):
        for i, params in enumerate(self._candidates()):
            if i >= self.max_evals:
                break
            self.trial(params)
