"""paddle_tpu_torch.resilience — deadlines and retry policy for serving."""
from .deadline import Deadline
from .retry import (RetryExhausted, RetryPolicy, TransientError,
                    is_transient, retry_call)

__all__ = ["Deadline", "RetryExhausted", "RetryPolicy", "TransientError",
           "is_transient", "retry_call"]
