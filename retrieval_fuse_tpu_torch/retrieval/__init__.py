from retrieval_fuse_tpu_torch.retrieval.dictionary import (
    create_dictionary, extract_features, extract_input_features, extract_target_features)
from retrieval_fuse_tpu_torch.retrieval.engine import (
    RetrievalInterface, query_dictionary_using_features, create_retrieval_from_mapping)

__all__ = [
    "create_dictionary", "extract_features", "extract_input_features", "extract_target_features",
    "RetrievalInterface", "query_dictionary_using_features", "create_retrieval_from_mapping",
]
