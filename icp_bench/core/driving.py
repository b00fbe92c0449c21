"""What every driver shares, and what a driver is.

A traffic mix names its driver, ``drivers/<driver>.py``, which the
harness loads by that name.  The file defines ``Driver``, built as
``Driver(config, traffic, seed, seconds, device)`` from the
configuration and the traffic (both as loaded from their files), the
seed of the run and the device, with:

* ``units_per_span``: the frames one traced span covers (a live frame:
  1; a chunk of batched frames: the chunk's frames);
* ``prepare_inputs()``: makes the inputs from the seed, and nothing else;
* ``input_frames()``: ``[(drive, frames)]``, the frames of each drive the
  window's answers cover at most;
* ``prepare()``: the inputs, the program, and a warm-up of every shape the
  window uses;
* ``measure(traced=None)``: the window, each traced unit inside
  ``span(traced, name, i)``; returns its (start, end) host seconds;
* ``frames()``: the frames the window attempted;
* ``metrics(start, end)``: ``{name: (value, unit)}`` of its end-to-end
  metrics;
* ``notes()``: a dict of what else the run saw, printed to standard error;
* ``answers()``: ``[(drive, program poses (F, 4, 4), overflow total)]``,
  what the window's calls returned;
* ``release()``: frees the program's state, keeping the answers.
"""

from __future__ import annotations

import contextlib


def port_config(config: dict, device):
    """The program's ``Config`` of a configuration file."""
    from kinematic_icp_tpu_torch.config import Config
    fields = dict(config["config"])
    if str(device) == "cpu":
        # the kernel branches run their plain version on CPU tensors
        fields["gn_backend"] = "auto"
    return Config(**fields)


def span(traced, name, i):
    """``traced.span(name, i)`` for a traced run, else nothing."""
    if traced is None:
        return contextlib.nullcontext()
    return traced.span(name, i)
