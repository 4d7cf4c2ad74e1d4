"""The serving subsystem: paged decoder, engine, metrics, weights."""

from dtf_tpu_torch.serve.bridge import (load_flax_npz,  # noqa: F401
                                        load_for_serving, random_init,
                                        serving_memory_plan)
from dtf_tpu_torch.serve.decode import (Decoder,  # noqa: F401
                                        teacher_forced_logits)
from dtf_tpu_torch.serve.engine import (Backpressure,  # noqa: F401
                                        PagePool, ServeEngine,
                                        ServeRequest, ServeResult)
from dtf_tpu_torch.serve.metrics import (ServingStats,  # noqa: F401
                                         collect_stats)
