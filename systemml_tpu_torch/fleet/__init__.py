"""The serving fleet of the PyTorch port. Only `admission` (the
MicroBatcher's bounded queue and deadline shedding) is ported; the
router, the replicas and the rollouts wait (ROADMAP queue 1, fleet)."""
