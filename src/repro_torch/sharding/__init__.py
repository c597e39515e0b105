# The placement rules of engine state over a rank grid (``repro.sharding``).
