"""Neural architecture search over the LitePose space: the evolutionary
finder, its efficiency and accuracy predictors, BN calibration."""

from .evolution import EvolutionFinder
from .predictors import AccuracyPredictor, EfficiencyPredictor

__all__ = ["EvolutionFinder", "AccuracyPredictor", "EfficiencyPredictor"]
