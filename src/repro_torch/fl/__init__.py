from repro_torch.fl.env import FLEnvironment, FLSimConfig, PopulationEnv
from repro_torch.fl.server import HAPFLServer, RoundRecord, WavePlan
from repro_torch.fl.batched import BatchedClientEngine
from repro_torch.fl.sharded import ShardedClientEngine
from repro_torch.fl.baselines import BaselineRecord, BaselineRunner
