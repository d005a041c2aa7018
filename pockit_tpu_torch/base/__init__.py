"""Problem-definition layer: symbolic frontend (System/Phase/Variable),
the static discretization data (``discretization.py``) and the bang-bang
mesh planner (``refine_discontinuous.py``), both plain numpy."""
