"""Training callbacks.

The port's own copy of lightgbmv1_tpu/callback.py (``EarlyStopException``,
``CallbackEnv``, ``log_evaluation`` :40, ``record_evaluation`` :58,
``reset_parameter`` :81 and ``early_stopping`` :102 with
``first_metric_only``), which mirrors the reference python-package
callback module (``python-package/lightgbm/callback.py`` —
``print_evaluation`` :55, ``record_evaluation`` :78, ``reset_parameter``
:109, ``early_stopping`` :150) with the same CallbackEnv contract.  Host
code: ``engine.train`` runs the callbacks around each iteration.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Union

from .utils.log import log_info, log_warning

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"],
)


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:  # cv result with stdv
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Print evaluation results every ``period`` iterations
    (reference name: print_evaluation)."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv) for x in env.evaluation_result_list
            )
            log_info(f"[{env.iteration + 1}]\t{result}")

    _callback.order = 10
    return _callback


print_evaluation = log_evaluation  # reference 3.x name


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result[data_name][eval_name].append(result)

    _callback.order = 20
    return _callback


def reset_parameter(**kwargs: Union[list, Callable]) -> Callable:
    """Reset parameters (e.g. learning_rate schedule) per iteration."""

    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                new_param = value[env.iteration - env.begin_iteration]
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)

    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Stop when no validation metric improves for ``stopping_rounds``
    iterations (reference: callback.py:150)."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[list] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    initialized = [False]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        initialized[0] = True
        enabled[0] = bool(env.evaluation_result_list)
        if not enabled[0]:
            log_warning("Early stopping requires at least one validation data")
            return
        if verbose:
            log_info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")
        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for item in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if item[3]:  # higher better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _callback(env: CallbackEnv) -> None:
        if not initialized[0]:
            _init(env)
        if not enabled[0]:
            return
        for i, item in enumerate(env.evaluation_result_list):
            data_name, eval_name, score = item[0], item[1], item[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if first_metric_only and first_metric[0] != eval_name.split(" ")[-1]:
                continue
            # never early-stop on the training split, whatever it was named
            # (reference checks env.model._train_data_name)
            if data_name == getattr(env.model, "_train_data_name", "training"):
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log_info(
                        f"Early stopping, best iteration is:\n[{best_iter[i] + 1}]\t"
                        + "\t".join(_format_eval_result(x) for x in best_score_list[i])
                    )
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    log_info(
                        f"Did not meet early stopping. Best iteration is:\n"
                        f"[{best_iter[i] + 1}]\t"
                        + "\t".join(_format_eval_result(x) for x in best_score_list[i])
                    )
                raise EarlyStopException(best_iter[i], best_score_list[i])

    _callback.order = 30
    return _callback
