"""The benchmark's harness: cells, jobs, weights, traces and costs."""
