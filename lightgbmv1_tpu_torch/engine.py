"""``train``: the training entry point (reference engine.py:18).

Port of lightgbmv1_tpu/engine.py ``train`` (:25) with ``valid_sets`` /
``valid_names`` and an evaluation of every valid set after each
iteration (recorded in ``evals_result`` when given, logged at
``verbose_eval``).  Callbacks and early stopping are not ported yet
(ROADMAP queue 1, callbacks and early stopping): asking for them raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .basic import Booster, Dataset
from .config import CALLBACKS, not_ported
from .device import DeviceLike
from .utils.log import log_info

_ROUND_ALIASES = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                  "num_trees", "num_round", "num_rounds", "num_boost_round",
                  "n_estimators")
_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                 "early_stopping", "n_iter_no_change")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          evals_result: Optional[Dict] = None, verbose_eval=False,
          callbacks=None, early_stopping_rounds: Optional[int] = None,
          device: DeviceLike = None) -> Booster:
    """Train a binary leaf-wise model on ``device`` (default: the card)."""
    params = dict(params or {})
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _STOP_ALIASES:
        if params.get(alias):
            early_stopping_rounds = int(params.pop(alias))
    if callbacks or (early_stopping_rounds or 0) > 0:
        raise not_ported("callbacks and early stopping", CALLBACKS)

    booster = Booster(params=params, train_set=train_set, device=device)
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    valid_sets = list(valid_sets or [])
    valid_names = list(valid_names or
                       [f"valid_{i}" for i in range(len(valid_sets))])
    for vs, name in zip(valid_sets, valid_names):
        # a valid set is binned with the training bins (reference
        # engine.py: valid_set.set_reference(train_set))
        if vs.reference is None and vs._binned is None:
            vs.reference = train_set
        booster.add_valid(vs, name)

    every = (1 if verbose_eval is True else
             int(verbose_eval) if verbose_eval else 0)
    for i in range(num_boost_round):
        finished = booster.update()
        if valid_sets:
            results = booster.eval_valid()
            if evals_result is not None:
                for ds_name, metric, value, _ in results:
                    evals_result.setdefault(ds_name, {}).setdefault(
                        metric, []).append(value)
            if every and (i + 1) % every == 0:
                log_info(f"[{i + 1}]\t" + "\t".join(
                    f"{d}'s {m}: {v:g}" for d, m, v, _ in results))
        if finished:
            break
    return booster
