from retrieval_fuse_tpu_torch.data.scene import SceneHandler
from retrieval_fuse_tpu_torch.data.patched_dataset import PatchedSceneDataset, CombinedDataset
from retrieval_fuse_tpu_torch.data.loader import batch_iterator

__all__ = ["SceneHandler", "PatchedSceneDataset", "CombinedDataset", "batch_iterator"]
