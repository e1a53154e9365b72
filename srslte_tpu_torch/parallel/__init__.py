from .mesh import make_mesh
from .halo import halo_extend, sharded_pss_search
from .pipeline import ShardedDlPipeline
