"""Continuous-batching serving over the paged KV pool (dense path)."""
from repro_torch.serve.adapters import FamilyCacheAdapter, get_adapter
from repro_torch.serve.buckets import (Bucket, BucketPlan, BucketRouter,
                                       BucketSpec)
from repro_torch.serve.engine import ServeEngine, ServeReport
from repro_torch.serve.kvcache import BlockAllocator, KVCachePool, Lease
from repro_torch.serve.metrics import ServeMetrics, ServeSummary
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.traffic import TrafficConfig, drive, synthesize

__all__ = ["FamilyCacheAdapter", "get_adapter", "Bucket", "BucketPlan",
           "BucketRouter", "BucketSpec", "ServeEngine", "ServeReport",
           "BlockAllocator", "KVCachePool", "Lease", "ServeMetrics",
           "ServeSummary", "Request", "Scheduler", "TrafficConfig", "drive",
           "synthesize"]
