from .pipeline import GraphBatchStream, RecsysStream, TokenStream

__all__ = ["TokenStream", "RecsysStream", "GraphBatchStream"]
