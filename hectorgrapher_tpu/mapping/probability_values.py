"""Occupancy probability math.

(ref: cartographer/mapping/probability_values.h). The reference encodes
probabilities as uint16 table lookups with an update-marker bit; here we
store float32 log-odds directly and a `known` mask, which reproduces the
same math (odds multiply == log-odds add; clamping to [0.1, 0.9]) without
tables. Per-scan single-update semantics are achieved structurally: the
inserters apply one masked elementwise update per scan instead of marking
cells (see inserters_2d.py/inserters_3d.py).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

MIN_PROBABILITY = 0.1
MAX_PROBABILITY = 1.0 - MIN_PROBABILITY
MIN_CORRESPONDENCE_COST = 1.0 - MAX_PROBABILITY
MAX_CORRESPONDENCE_COST = 1.0 - MIN_PROBABILITY

# Computed in pure Python: a device computation at import time would cost a
# device-to-host transfer before any user code runs.
MIN_LOG_ODDS = math.log(MIN_PROBABILITY / (1.0 - MIN_PROBABILITY))
MAX_LOG_ODDS = math.log(MAX_PROBABILITY / (1.0 - MAX_PROBABILITY))


def odds(probability):
    return probability / (1.0 - probability)


def probability_from_odds(o):
    return o / (o + 1.0)


def log_odds(probability):
    return jnp.log(probability) - jnp.log1p(-probability)


def probability_from_log_odds(lo):
    return jax_sigmoid(lo)


def jax_sigmoid(x):
    return 1.0 / (1.0 + jnp.exp(-x))


def clamp_probability(p):
    return jnp.clip(p, MIN_PROBABILITY, MAX_PROBABILITY)


def clamp_log_odds(lo):
    return jnp.clip(lo, MIN_LOG_ODDS, MAX_LOG_ODDS)


def probability_to_correspondence_cost(p):
    return 1.0 - p
