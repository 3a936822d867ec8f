"""Species activity-pattern database for Stage-2 re-ranking.

Counterpart of ``telescope_cam_detection_tpu/pipeline/activity.py`` (reference
``src/species_activity_patterns.py:21-313``), the port's own copy: a
species-name -> activity-pattern table covering the Mojave whitelist
(config geographic_filter.allowed_species), with keyword heuristics for
unknown names (owls/bats/geckos are nocturnal, etc.) and the
``is_species_likely_active`` predicate used by the two-stage re-ranker.
"""
from __future__ import annotations

from typing import Dict, Optional

from telescope_cam_detection_tpu_torch.pipeline.time_of_day import (
    ActivityPattern,
    TimeOfDay,
    _ACTIVE_WINDOWS,
)

D = ActivityPattern.DIURNAL
N = ActivityPattern.NOCTURNAL
C = ActivityPattern.CREPUSCULAR
A = ActivityPattern.CATHEMERAL

SPECIES_ACTIVITY_PATTERNS: Dict[str, ActivityPattern] = {
    # mammals
    "coyote": C, "desert cottontail": C, "black-tailed jackrabbit": C,
    "antelope jackrabbit": C, "white-tailed antelope squirrel": D,
    "harris's antelope squirrel": D, "round-tailed ground squirrel": D,
    "rock squirrel": D, "bobcat": C, "mountain lion": C, "cougar": C,
    "gray fox": N, "kit fox": N, "mule deer": C, "collared peccary": C,
    "javelina": C, "desert bighorn sheep": D, "ringtail": N,
    "american badger": N, "striped skunk": N, "western spotted skunk": N,
    "desert woodrat": N, "merriam's kangaroo rat": N, "desert kangaroo rat": N,
    "desert pocket mouse": N, "cactus mouse": N,
    "southern grasshopper mouse": N, "desert shrew": A,
    "california leaf-nosed bat": N, "mexican free-tailed bat": N,
    "pallid bat": N,
    # birds
    "gambel's quail": D, "greater roadrunner": D, "cactus wren": D,
    "curve-billed thrasher": D, "le conte's thrasher": D,
    "bendire's thrasher": D, "red-tailed hawk": D, "harris's hawk": D,
    "cooper's hawk": D, "sharp-shinned hawk": D, "golden eagle": D,
    "great horned owl": N, "barn owl": N, "burrowing owl": C, "elf owl": N,
    "western screech-owl": N, "turkey vulture": D, "black vulture": D,
    "common raven": D, "chihuahuan raven": D, "american crow": D,
    "mourning dove": D, "white-winged dove": D, "inca dove": D,
    "common ground dove": D, "gila woodpecker": D,
    "ladder-backed woodpecker": D, "gilded flicker": D, "northern flicker": D,
    "verdin": D, "black-throated sparrow": D, "white-crowned sparrow": D,
    "house finch": D, "lesser goldfinch": D, "phainopepla": D,
    "loggerhead shrike": D, "northern mockingbird": A,
    "costa's hummingbird": D, "anna's hummingbird": D,
    "black-chinned hummingbird": D, "rufous hummingbird": D, "rock wren": D,
    "canyon wren": D, "black-tailed gnatcatcher": D,
    "blue-gray gnatcatcher": D, "say's phoebe": D,
    "ash-throated flycatcher": D, "vermilion flycatcher": D, "horned lark": D,
    # reptiles
    "desert iguana": D, "common chuckwalla": D, "chuckwalla": D,
    "desert spiny lizard": D, "clark's spiny lizard": D,
    "zebra-tailed lizard": D, "greater earless lizard": D,
    "desert horned lizard": D, "flat-tailed horned lizard": D,
    "long-nosed leopard lizard": D, "collared lizard": D,
    "desert collared lizard": D, "common side-blotched lizard": D,
    "desert night lizard": N, "western banded gecko": N,
    "desert banded gecko": N, "mediterranean gecko": N,
    "western diamondback rattlesnake": C, "mojave rattlesnake": C,
    "sidewinder": N, "speckled rattlesnake": C, "gopher snake": A,
    "gophersnake": A, "common kingsnake": C, "california kingsnake": C,
    "long-nosed snake": N, "coachwhip": D, "red coachwhip": D,
    "glossy snake": N, "western patch-nosed snake": D,
    "desert tortoise": D, "mohave desert tortoise": D,
    # amphibians
    "couch's spadefoot": N, "great basin spadefoot": N,
    "red-spotted toad": N, "sonoran desert toad": N, "colorado river toad": N,
    # arthropods
    "desert hairy scorpion": N, "arizona bark scorpion": N,
    "desert blonde tarantula": N, "tarantula": N,
    # domestic / people
    "domestic dog": A, "domestic cat": A, "human": A, "person": A,
}

# keyword fallbacks (reference species_activity_patterns.py:216-242)
_KEYWORD_PATTERNS = (
    ("owl", N), ("bat", N), ("gecko", N), ("scorpion", N), ("tarantula", N),
    ("woodrat", N), ("kangaroo rat", N), ("pocket mouse", N), ("skunk", N),
    ("badger", N), ("ringtail", N), ("toad", N), ("nighthawk", N),
    ("hawk", D), ("eagle", D), ("falcon", D), ("vulture", D), ("quail", D),
    ("dove", D), ("sparrow", D), ("finch", D), ("wren", D), ("hummingbird", D),
    ("woodpecker", D), ("lizard", D), ("iguana", D), ("tortoise", D),
    ("roadrunner", D), ("squirrel", D), ("raven", D), ("crow", D),
    ("rattlesnake", C), ("snake", C), ("coyote", C), ("fox", C),
    ("rabbit", C), ("jackrabbit", C), ("cottontail", C), ("deer", C),
    ("bobcat", C), ("lion", C), ("peccary", C), ("javelina", C),
)


def get_activity_pattern(species_name: str) -> Optional[ActivityPattern]:
    if not species_name:
        return None
    name = species_name.lower().strip()
    if name in SPECIES_ACTIVITY_PATTERNS:
        return SPECIES_ACTIVITY_PATTERNS[name]
    for keyword, pattern in _KEYWORD_PATTERNS:
        if keyword in name:
            return pattern
    return None


def is_species_likely_active(species_name: str, time_of_day: str) -> bool:
    """True unless the species' known pattern excludes this time of day
    (reference species_activity_patterns.py:266-313; unknown -> True)."""
    pattern = get_activity_pattern(species_name)
    if pattern is None:
        return True
    try:
        tod = TimeOfDay(time_of_day)
    except ValueError:
        return True
    return tod in _ACTIVE_WINDOWS[pattern]
