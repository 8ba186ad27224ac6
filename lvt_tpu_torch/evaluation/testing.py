"""Result printing and regression gating
(reference: vidgen/evaluation/testing.py:10-78)."""

import logging
import pprint
import sys
from collections.abc import Mapping

logger = logging.getLogger(__name__)


def print_csv_format(results):
    """Log metrics in a copy-pasteable csv form (reference testing.py:10-25)."""
    assert isinstance(results, Mapping) or not len(results)
    for task, res in results.items():
        important = {k: v for k, v in res.items() if "-" not in k}
        logger.info("copypaste: Task: {}".format(task))
        logger.info("copypaste: " + ",".join(important.keys()))
        logger.info("copypaste: " + ",".join([f"{v:.4f}" for v in important.values()]))


def verify_results(cfg, results) -> bool:
    """Check results against TEST.EXPECTED_RESULTS (task, metric, expected,
    tolerance); exits 1 on failure (reference testing.py:28-58)."""
    expected_results = cfg.TEST.EXPECTED_RESULTS
    if not len(expected_results):
        return True

    ok = True
    for task, metric, expected, tolerance in expected_results:
        actual = results[task][metric]
        if not isinstance(actual, (float, int)):
            ok = False
            continue
        diff = abs(actual - expected)
        if diff > tolerance:
            ok = False

    logger.info("Result verification: " + ("*Passed*" if ok else "*FAILED*"))
    if not ok:
        logger.error("Expected results: " + str(expected_results))
        logger.error("Actual results: " + pprint.pformat(results))
        sys.exit(1)
    return ok


def flatten_results_dict(results):
    """{'a': {'b': 1}} -> {'a/b': 1} (reference testing.py:61-78)."""
    r = {}
    for k, v in results.items():
        if isinstance(v, Mapping):
            for kk, vv in flatten_results_dict(v).items():
                r[k + "/" + kk] = vv
        else:
            r[k] = v
    return r
