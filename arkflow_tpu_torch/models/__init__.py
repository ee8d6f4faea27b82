"""Model families of the port: ``bert_classifier``, ``decoder_lm``,
``lstm_ae`` and ``vit_embedder``, the JAX package's four."""

from arkflow_tpu_torch.models.registry import get_model, list_models, register_model  # noqa: F401

import arkflow_tpu_torch.models.bert  # noqa: F401
import arkflow_tpu_torch.models.lstm_ae  # noqa: F401
import arkflow_tpu_torch.models.vit  # noqa: F401
import arkflow_tpu_torch.models.decoder  # noqa: F401
