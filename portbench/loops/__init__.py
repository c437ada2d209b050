"""The benchmark's loops, one module each, chosen by a traffic file's
``loop`` key: ``act`` (policy in the loop over a batch of envs) and
``train`` (A2C rounds)."""
