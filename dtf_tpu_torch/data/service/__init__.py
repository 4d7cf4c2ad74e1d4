"""Host-side data service: multi-process sharded deterministic readers
with a decode-once cache tier -- a copy of ``dtf_tpu/data/service``.
Nothing here imports torch, so the spawned readers never touch the card.

Why this exists: JPEG decode and augmentation are per-image host work
and the remaining serial fraction of the legacy pipeline is GIL-held
Python, so threads cannot close the gap between one host core and what
a card consumes.  This package scales decode across spawned PROCESSES and
makes every batch a pure function of position, which makes
killed-at-K resume on imagenet bit-exact, not best-effort re-keyed.

Pieces (see each module's docstring for the full design):

  reader.ShardReader   one static shard of the TFRecord file set,
                       served as position-derived batches
  cache.DecodeCache    per-shard mmap-backed decode-once cache
  pool.ServiceStream   worker-pool supervisor + deterministic
                       round-robin merged stream (the input_fn surface)
"""

from dtf_tpu_torch.data.service.cache import DecodeCache  # noqa: F401
from dtf_tpu_torch.data.service.pool import (ServiceStream,  # noqa: F401
                                       service_input_fn, shard_positions)
from dtf_tpu_torch.data.service.reader import (ShardReader,  # noqa: F401
                                         index_tfrecord_file, make_reader)
