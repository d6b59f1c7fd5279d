from repro_torch.utils.pytree import (tree_add, tree_leaves, tree_map,
                                      tree_scale, tree_weighted_sum)
