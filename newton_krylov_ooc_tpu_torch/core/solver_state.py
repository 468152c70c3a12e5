"""resumable solver state: JSON write-ahead step log + key/value store.

This is the out-of-core heart of the framework (capability parity with
nk_ooc/solver_state.py): every completed solver action appends a step string to
a JSON-backed log; on --resume the log is replayed and completed work is skipped
(results re-loaded from the files it produced); --rewind pops the last step to
retry a failed action.  Scalars and ndarrays (Armijo factors, GMRES Hessenberg
matrices, ...) persist into the same JSON with an ndarray codec.

This is the preemption-recovery story: a solve killed between any two logged
steps restarts from the log with no recomputation.  The port's own copy of
newton_krylov_ooc_tpu/core/solver_state.py.
"""

from __future__ import annotations

import functools
import json
import logging
import os

import numpy as np

from ..utils.ncio import mkdir_exist_okay


class NumpyEncoder(json.JSONEncoder):
    """JSON encoder handling numpy ndarrays and scalars"""

    def default(self, o):
        if isinstance(o, np.ndarray):
            return {"__ndarray__": o.tolist()}
        if isinstance(o, np.generic):
            return o.item()
        return json.JSONEncoder.default(self, o)


def json_ndarray_decode(dct):
    """object hook decoding __ndarray__-tagged entries"""
    if "__ndarray__" in dct:
        return np.asarray(dct["__ndarray__"])
    return dct


_MISSING = object()


class SolverState:
    """state of an iterative solver: iteration counter, step log, KV store"""

    def __init__(self, name, workdir, resume=False, rewind=False, tolerate_missing=False):
        logger = logging.getLogger(__name__)
        logger.debug(
            'SolverState, name="%s", workdir="%s", resume="%r", rewind="%r"',
            name,
            workdir,
            resume,
            rewind,
        )

        mkdir_exist_okay(workdir)

        self._name = name
        self._workdir = workdir
        self._state_fname = os.path.join(workdir, f"{name}_state.json")
        self._rewound_step_string = None

        if resume:
            if tolerate_missing and not rewind and not os.path.exists(self._state_fname):
                # a crash can land between a parent solver intent-logging
                # this solver's instantiation and the first write of this
                # state file; a child solver resuming then starts fresh
                # instead of raising.  Top-level solvers do NOT set
                # tolerate_missing: a --resume against a missing state file
                # there is a user error (wrong workdir) and must fail loudly,
                # as must --rewind (there is no step to pop).
                logger.info(
                    'resume for "%s" with no state file; starting fresh',
                    self._name,
                )
                self._saved_state = {"iteration": 0, "step_log": []}
                self.log_step("__init__", per_iteration=False)
                return
            self._read()
            self._log_state()
            if rewind:
                self._rewound_step_string = self._saved_state["step_log"].pop()
                logger.info(
                    'rewinding step "%s" for "%s"',
                    self._rewound_step_string,
                    self._name,
                )
        else:
            if rewind:
                raise RuntimeError(
                    f"rewind cannot be True if resume is False, name={self._name}"
                )
            self._saved_state = {"iteration": 0, "step_log": []}
            self.log_step("__init__", per_iteration=False)
            logger.info(
                '"%s" iteration now %d', self._name, self._saved_state["iteration"]
            )

    # -- queries -----------------------------------------------------------

    def get_workdir(self):
        return self._workdir

    def get_iteration(self):
        return self._saved_state["iteration"]

    def step_logged(self, stepval, per_iteration=True):
        """has this step been logged (in the current iteration, if per_iteration)"""
        return self._step_string(stepval, per_iteration) in self._saved_state["step_log"]

    def step_was_rewound(self, stepval, per_iteration=True):
        """was this step the one popped by --rewind"""
        if self._rewound_step_string is None:
            return False
        return self._step_string(stepval, per_iteration) == self._rewound_step_string

    # -- mutations -----------------------------------------------------------

    def inc_iteration(self):
        """advance the iteration counter (step strings are namespaced by it)"""
        logger = logging.getLogger(__name__)
        self._saved_state["iteration"] += 1
        self.log_step("inc_iteration")
        logger.info('"%s" iteration now %d', self._name, self._saved_state["iteration"])
        return self._saved_state["iteration"]

    def log_step(self, stepval, per_iteration=True):
        """append a step to the log (idempotent) and flush to disk"""
        logger = logging.getLogger(__name__)
        if self.step_logged(stepval, per_iteration):
            logger.debug('"%s" already in step_log', stepval)
            return
        logger.debug('adding "%s" to step_log', stepval)
        self._saved_state["step_log"].append(self._step_string(stepval, per_iteration))
        self._write()

    def set_value_saved_state(self, key, value, defer=False):
        """persist a key/value pair, verifying round-trip fidelity

        defer=True stages the value in memory only; it lands on disk in the
        same file write as the next log_step/inc_iteration, committing the
        value and the step append atomically (a crash before that write
        leaves neither)
        """
        self._saved_state[key] = value
        if defer:
            return
        self._write()
        self._read()
        recovered = self._saved_state[key]
        if isinstance(value, np.ndarray):
            if not np.array_equal(recovered, value):
                raise RuntimeError("saved_state value not recovered on reread")
        elif recovered != value:
            raise RuntimeError("saved_state value not recovered on reread")

    def get_value_saved_state(self, key, default=_MISSING):
        if key in self._saved_state:
            return self._saved_state[key]
        if default is _MISSING:
            raise KeyError(key)
        return default

    # -- internals -----------------------------------------------------------

    def _step_string(self, stepval, per_iteration):
        return f"{self.get_iteration():02}:{stepval}" if per_iteration else stepval

    def _log_state(self):
        logger = logging.getLogger(__name__)
        logger.debug('name="%s"', self._name)
        logger.debug("iteration=%d", self._saved_state["iteration"])
        for step_name in self._saved_state["step_log"]:
            logger.debug('"%s" logged', step_name)

    def _write(self):
        # write-to-temp + atomic rename: a kill at any instant leaves either
        # the previous state file or the new one, never a truncated JSON --
        # the property the write-ahead step-log commit points rely on
        tmp_fname = self._state_fname + ".tmp"
        with open(tmp_fname, mode="w") as fptr:
            json.dump(self._saved_state, fptr, indent=2, cls=NumpyEncoder)
            fptr.write("\n")
        os.replace(tmp_fname, self._state_fname)

    def _read(self):
        with open(self._state_fname, mode="r") as fptr:
            self._saved_state = json.load(fptr, object_hook=json_ndarray_decode)


def action_step_log_wrap(step, per_iteration=True, post_exit=False):
    """
    decorator wrapping a void action in step_logged/log_step bookkeeping

    The wrapped function must accept solver_state as a keyword argument; passing
    solver_state=None disables logging (direct, in-core execution).  step may
    contain {}-fields formatted from the function's keyword arguments.  With
    post_exit=True the process exits after the action is first performed -- the
    hook used by external (batch-submitted) models.
    """

    def outer_wrapper(func):
        @functools.wraps(func)
        def inner_wrapper(*args, **kwargs):
            solver_state = kwargs["solver_state"]
            if solver_state is not None and solver_state.step_logged(
                step.format(**kwargs), per_iteration
            ):
                return None
            func(*args, **kwargs)
            if solver_state is not None:
                solver_state.log_step(step.format(**kwargs), per_iteration)
            if post_exit:
                raise SystemExit
            return None

        return inner_wrapper

    return outer_wrapper
