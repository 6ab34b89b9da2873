"""Regularized evolutionary architecture search (the port's copy of
``litepose_tpu/nas/evolution.py``, held to it by tests/test_torch_nas.py).

Search loop semantics follow the reference finder
(``arch_search/evolution.py``): population 40, 40
iterations, parent ratio 0.25, mutation probability 0.1, half the
population from mutation and half from crossover, with rejection sampling
against an efficiency (MACs) constraint.  Differences: explicit numpy RNG
(reproducible), and the efficiency predictor is pure arithmetic over the
arch descriptor (instant — no model instantiation, unlike ptflops).
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..arch.manager import ArchManager
from ..arch.schema import ArchConfig


class EvolutionFinder:
    def __init__(
        self,
        efficiency_predictor: Callable[[ArchConfig], float],
        accuracy_predictor: Callable[[ArchConfig], float],
        arch_manager: Optional[ArchManager] = None,
        population_size: int = 40,
        max_time_budget: int = 40,
        mutate_prob: float = 0.1,
        parent_ratio: float = 0.25,
        mutation_ratio: float = 0.5,
        seed: int = 0,
    ):
        self.efficiency = efficiency_predictor
        self.accuracy = accuracy_predictor
        self.manager = arch_manager or ArchManager()
        self.population_size = population_size
        self.max_time_budget = max_time_budget
        self.mutate_prob = mutate_prob
        self.parent_ratio = parent_ratio
        self.mutation_ratio = mutation_ratio
        self.rng = np.random.default_rng(seed)

    # -- sampling under constraint ------------------------------------------

    def random_valid_sample(self, constraint: float) -> Tuple[ArchConfig, float]:
        while True:
            arch = self.manager.random_sample(self.rng)
            eff = self.efficiency(arch)
            if eff <= constraint:
                return arch, eff

    def mutate_sample(self, arch: ArchConfig, constraint: float) -> Tuple[ArchConfig, float]:
        while True:
            d = arch.to_dict()
            if self.rng.random() < self.mutate_prob:
                d["img_size"] = int(
                    self.manager.img_sizes[self.rng.integers(len(self.manager.img_sizes))]
                )
            if self.rng.random() < self.mutate_prob:
                d["input_channel"] = self.manager.rand_channel(
                    self.manager.input_channel, self.rng
                )
            for i, base in enumerate(self.manager.deconv_setting):
                if self.rng.random() < self.mutate_prob:
                    d["deconv_setting"][i] = self.manager.rand_channel(base, self.rng)
            for i, (c, _, _) in enumerate(self.manager.stage_setting):
                if self.rng.random() < self.mutate_prob:
                    d["backbone_setting"][i]["channel"] = self.manager.rand_channel(c, self.rng)
            cand = ArchConfig.from_dict(d)
            eff = self.efficiency(cand)
            if eff <= constraint:
                return cand, eff

    def crossover_sample(self, a: ArchConfig, b: ArchConfig, constraint: float):
        while True:
            da, db = a.to_dict(), b.to_dict()
            d = copy.deepcopy(da)
            for key in ("img_size", "input_channel"):
                d[key] = (da if self.rng.random() < 0.5 else db)[key]
            for i in range(len(d["deconv_setting"])):
                d["deconv_setting"][i] = (da if self.rng.random() < 0.5 else db)["deconv_setting"][i]
            for i in range(len(d["backbone_setting"])):
                d["backbone_setting"][i]["channel"] = (
                    da if self.rng.random() < 0.5 else db
                )["backbone_setting"][i]["channel"]
            cand = ArchConfig.from_dict(d)
            eff = self.efficiency(cand)
            if eff <= constraint:
                return cand, eff

    # -- main loop -------------------------------------------------------------

    def run_evolution_search(
        self, constraint: float, verbose: bool = False, logger=None
    ) -> Tuple[float, ArchConfig, List[float]]:
        """Returns (best accuracy, best arch, per-iteration best history)."""
        n_mutation = int(round(self.population_size * self.mutation_ratio))
        n_parents = max(int(round(self.population_size * self.parent_ratio)), 1)

        population: List[Tuple[float, ArchConfig]] = []
        for _ in range(self.population_size):
            arch, _ = self.random_valid_sample(constraint)
            population.append((self.accuracy(arch), arch))

        history: List[float] = []
        best: Tuple[float, ArchConfig] = max(population, key=lambda t: t[0])
        for it in range(self.max_time_budget):
            parents = sorted(population, key=lambda t: t[0], reverse=True)[:n_parents]
            if parents[0][0] > best[0]:
                best = parents[0]
            history.append(best[0])
            if logger:
                logger.info(f"evolution iter {it}: best acc {best[0]:.4f}")
            elif verbose:
                print(f"iter {it}: best acc {best[0]:.4f}")

            population = list(parents)
            for _ in range(n_mutation):
                parent = parents[self.rng.integers(len(parents))][1]
                child, _ = self.mutate_sample(parent, constraint)
                population.append((self.accuracy(child), child))
            while len(population) < self.population_size + n_parents:
                pa = parents[self.rng.integers(len(parents))][1]
                pb = parents[self.rng.integers(len(parents))][1]
                child, _ = self.crossover_sample(pa, pb, constraint)
                population.append((self.accuracy(child), child))

        best_from_final = max(population, key=lambda t: t[0])
        if best_from_final[0] > best[0]:
            best = best_from_final
        return best[0], best[1], history
