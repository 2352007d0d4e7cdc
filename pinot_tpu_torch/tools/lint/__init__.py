"""graftlint for the port: the AST invariant checker aimed at
``pinot_tpu_torch``.

The same families as the JAX package's checker, over the port's own
source and idioms:

- ``lock-guard`` / ``lock-order`` (locks.py): ``# guarded-by: <lock>``
  fields are touched only under ``with self.<lock>`` (or in a private
  helper whose every call in its class holds the lock); the cross-module
  lock-acquisition graph has no A->B / B->A inversion.
- ``pairing`` (pairing.py): ``begin_query``/``end_query``,
  ``acquire_segments``/``release_segments``, ``admit``/``release`` pair
  through a ``finally`` (a list of tickets released in a ``finally``
  counts) or a context manager.
- ``threads`` (threads.py): every field of a class touched by two thread
  roles (request, the launcher's dispatcher, the prefetcher, the sampler,
  consumers, gauge scrapes, writers such as the minion) is guarded,
  confined, published before spawn, or waived with a ``# race-ok:`` code
  registered in ``common/tracing.py`` ``RACE_OK_REASONS``.
- ``wire`` / ``config`` (wire.py): every ``QueryStats`` field rides
  ``to_dict`` / ``merge`` / ``from_dict`` (a loop over a table of names
  counts for each name in it); every ``pinot.server.*`` /
  ``pinot.broker.*`` key is declared in ``spi/config.py``.
- ``configkeys`` (configkeys.py): the README's table of the port's keys
  against ``spi/config.py``'s declared defaults.
- ``conservation`` (conservation.py): resident removals release, inserts
  re-run byte accounting, ``nbytes()`` / ``release()`` classes count and
  clear what they populate (a running byte counter bumped beside the
  insert counts; ``release()`` may delegate to a ``self`` helper), spans
  close.
- ``decisions`` / ``decline`` (decisions.py, declines.py): every
  fallback reaches the decision ledger, and every reason literal is
  registered (in ``common/tracing.py`` or a table it imports into its
  registry); ``engine/fused_scan.py``'s ``_Ineligible`` / ``decline``
  codes resolve through ``_DECLINE_RULES`` / ``DIRECT_DECLINE_CODES``.
- ``exactness`` (exactness.py): wide integer bounds come from
  ``common/bounds.py``.
- ``protocol`` (protocol.py): ``engine/plan.py``'s positional static
  parameters against every ``pc.take()`` consumer (``engine/kernels.py``,
  ``engine/fused_scan.py``).
- ``sync`` (sync.py): a torch tensor on a device reaching an implicit
  host sync (``.item()``, ``.tolist()``, ``.cpu()``, ``int()``,
  ``float()``, ``np.asarray()``, ``torch.cuda.synchronize()``) under a
  lock, on the launcher's dispatcher thread or in a gauge callback.
- ``tracer`` (tracer.py): code reachable from ``torch.compile``,
  ``torch.jit.script`` or ``torch.cuda.graph`` does no host effect.
- ``device`` (device.py): the mesh axis names, ``narrow_plan_groups``'s
  power-of-two capacities, the star-tree index pad and the fused scan's
  LUT run cap against its config default.

Pure stdlib ``ast``: importing this package never imports torch, numpy
or the package it checks. ``python -m pinot_tpu_torch.tools.lint``.
"""

from pinot_tpu_torch.tools.lint.core import (
    Finding,
    LintContext,
    load_baseline,
    run_lint,
)

__all__ = ["Finding", "LintContext", "load_baseline", "run_lint"]
