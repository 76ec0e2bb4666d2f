from repro_torch.checkpoint.checkpointer import Checkpointer, save_tree, load_tree

__all__ = ["Checkpointer", "save_tree", "load_tree"]
