"""The port's microbatched and compressed train steps against the
reference's: two ``make_train_step`` updates per family (the reduced float32
configs and the tolerances of ``tests/test_torch_train.py``) with two
microbatches (gradients accumulated as ``grad.float() / k`` in float32), and
with the ``topk`` and ``int8`` gradient compression hooks.

The loss and grad norm of every step are held at 1e-5, and the parameters
and moments after two steps at 1e-5 entry by entry.  A compressed step is
discontinuous in the gradient: an entry whose scaled value lies within the
two packages' float32 difference (~1e-6 relative) of an int8 rounding
boundary (x.5) rounds to neighbouring integers in the two, which moves its
compressed gradient by one quantum (max|g|/127), and likewise an entry at
the top-k threshold.  Up to 1e-4 of a tensor's entries (at least one) may so
miss the tolerance in the compressed steps (int8: 2 of 65,536 in one leaf on
these inputs; top-k: none).  Top-k's threshold is the k-th largest
magnitude, a value, so the order in which ``torch.topk`` and
``jax.lax.top_k`` list tied entries does not change which entries are kept;
``tests/test_torch_optim.py`` holds both functions to the reference on the
same gradients exactly.
"""

import pytest
import torch

from test_torch_train import FAMILIES, check_steps

torch.set_num_threads(1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("variant", ["microbatches2", "topk", "int8"])
def test_train_step_variant_matches_reference(family, variant):
    if variant == "microbatches2":
        check_steps(family, microbatches=2)
    else:
        check_steps(family, flips=1e-4, compression=variant)
