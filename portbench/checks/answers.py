"""The comparison that decides ``correct``.

The answers the timed path produced in the window (a share of them
drawn from the run's seed, ``window.Sampler``; every answer of a traced
run's slices) are held against the plain reference
(``reference/<name>.py``, named by the configuration), which is run once
per distinct query after the window, on the benchmark's own postings.
An answer is right when its count equals the reference's and its doc ids
equal the reference's first ``max_results`` ids, in order.  Each number
compared is exact, so each limit is 0:

    wrong_answers    answers checked whose count or ids differ from the
                     reference
    missing_answers  queries sent in the window that got no answer
"""

from __future__ import annotations

import numpy as np

LIMITS = {"wrong_answers": 0, "missing_answers": 0}


def compare(sent: list[tuple], n_answered: int, kept: list, truth: dict,
            max_results: int) -> dict:
    """``sent``: the term tuples of the queries sent, in order;
    ``n_answered``: how many answers came back; ``kept``: (position,
    result) of the answers checked, a result having ``count`` and
    ``docs``; ``truth``: term tuple -> the reference's sorted ids."""
    wrong = 0
    for pos, res in kept:
        ref = truth[sent[pos]]
        docs = np.asarray(res.docs)
        if (int(res.count) != ref.size
                or not np.array_equal(docs, ref[:max_results])):
            wrong += 1
    return {"wrong_answers": wrong,
            "missing_answers": max(len(sent) - n_answered, 0)}


def judge(reference, corpus, runs: list, device,
          traffic: dict) -> tuple[dict, dict]:
    """The numbers compared over ``runs`` (the window's and each traced
    slice's ``(sent, n_answered, kept)``), and the reference's answers to
    every query judged."""
    queries = {sent[pos] for sent, _, kept in runs for pos, _ in kept}
    truth = reference.truth(corpus, queries, device)
    numbers = dict.fromkeys(LIMITS, 0)
    for sent, n_answered, kept in runs:
        for k, v in compare(sent, n_answered, kept, truth,
                            traffic["max_results"]).items():
            numbers[k] += v
    return numbers, truth


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= limit for k, limit in LIMITS.items())


def lines(numbers: dict) -> list[str]:
    """One line a number compared, with its limit."""
    return [f"check {k}: {numbers[k]} (limit {LIMITS[k]})" for k in LIMITS]
