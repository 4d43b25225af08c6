from .sharding import MeshRules, constrain, current_rules, use_rules

__all__ = ["MeshRules", "constrain", "current_rules", "use_rules"]
