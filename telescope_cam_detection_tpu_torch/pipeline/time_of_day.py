"""Time-of-day detection filter.

Counterpart of ``telescope_cam_detection_tpu/pipeline/time_of_day.py`` (itself
a behavioral port of reference ``src/time_of_day_filter.py:30-378``), kept
here as the port's own copy: wall clock maps to dawn/day/dusk/night; per-class activity patterns mark out-of-pattern
detections, which are confidence-penalized (or hard-filtered) and annotated
with alternatives for Stage 2. Pure host Python — this is control-plane logic,
not device work.
"""
from __future__ import annotations

import logging
import threading
from datetime import datetime, time as dtime
from enum import Enum
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class TimeOfDay(str, Enum):
    DAWN = "dawn"
    DAY = "day"
    DUSK = "dusk"
    NIGHT = "night"


class ActivityPattern(str, Enum):
    DIURNAL = "diurnal"
    NOCTURNAL = "nocturnal"
    CREPUSCULAR = "crepuscular"
    CATHEMERAL = "cathemeral"


# Reference time bands (time_of_day_filter.py:95-100)
TIME_RANGES = {
    TimeOfDay.DAWN: (dtime(5, 0), dtime(8, 0)),
    TimeOfDay.DAY: (dtime(8, 0), dtime(17, 0)),
    TimeOfDay.DUSK: (dtime(17, 0), dtime(21, 0)),
    TimeOfDay.NIGHT: (dtime(21, 0), dtime(5, 0)),  # wraps midnight
}

# Activity windows per pattern (time_of_day_filter.py:188-210). Diurnal
# excludes dusk deliberately: truly diurnal species roost by sunset.
_ACTIVE_WINDOWS = {
    ActivityPattern.CATHEMERAL: set(TimeOfDay),
    ActivityPattern.DIURNAL: {TimeOfDay.DAWN, TimeOfDay.DAY},
    ActivityPattern.NOCTURNAL: {TimeOfDay.DUSK, TimeOfDay.NIGHT, TimeOfDay.DAWN},
    ActivityPattern.CREPUSCULAR: {TimeOfDay.DAWN, TimeOfDay.DUSK, TimeOfDay.NIGHT},
}

DEFAULT_ACTIVITY_PATTERNS: Dict[str, ActivityPattern] = {
    "bird": ActivityPattern.DIURNAL,
    "quail": ActivityPattern.DIURNAL,
    "roadrunner": ActivityPattern.DIURNAL,
    "hawk": ActivityPattern.DIURNAL,
    "raven": ActivityPattern.DIURNAL,
    "dove": ActivityPattern.DIURNAL,
    "owl": ActivityPattern.NOCTURNAL,
    "coyote": ActivityPattern.CREPUSCULAR,
    "rabbit": ActivityPattern.CREPUSCULAR,
    "fox": ActivityPattern.CREPUSCULAR,
    "deer": ActivityPattern.CREPUSCULAR,
    "javelina": ActivityPattern.CREPUSCULAR,
    "bobcat": ActivityPattern.CREPUSCULAR,
    "cat": ActivityPattern.CATHEMERAL,
    "dog": ActivityPattern.CATHEMERAL,
    "lizard": ActivityPattern.DIURNAL,
    "iguana": ActivityPattern.DIURNAL,
    "tortoise": ActivityPattern.DIURNAL,
    "snake": ActivityPattern.CREPUSCULAR,
    "person": ActivityPattern.CATHEMERAL,
    "bat": ActivityPattern.NOCTURNAL,
    "scorpion": ActivityPattern.NOCTURNAL,
    "bear": ActivityPattern.CREPUSCULAR,
}

# Stage-2 hints when a class is seen out of pattern
# (time_of_day_filter.py:45-57)
ALTERNATIVE_SUGGESTIONS: Dict[str, Dict[TimeOfDay, List[str]]] = {
    "bird": {TimeOfDay.NIGHT: ["bat", "insect", "moth"], TimeOfDay.DUSK: ["bat"]},
    "lizard": {TimeOfDay.NIGHT: ["gecko"]},
    "snake": {TimeOfDay.DAY: ["snake"], TimeOfDay.NIGHT: ["snake"]},
}


def classify_time_of_day(now: Optional[datetime] = None) -> TimeOfDay:
    t = (now or datetime.now()).time()
    for tod, (start, end) in TIME_RANGES.items():
        if start <= end:
            if start <= t < end:
                return tod
        else:  # wraps midnight
            if t >= start or t < end:
                return tod
    return TimeOfDay.DAY


class TimeOfDayFilter:
    def __init__(
        self,
        enabled: bool = True,
        confidence_penalty: float = 0.3,
        hard_filter: bool = False,
        activity_patterns: Optional[Dict[str, ActivityPattern]] = None,
        use_system_timezone: bool = True,
    ):
        self.enabled = enabled
        self.confidence_penalty = confidence_penalty
        self.hard_filter = hard_filter
        self.use_system_timezone = use_system_timezone
        self.activity_patterns = dict(DEFAULT_ACTIVITY_PATTERNS)
        if activity_patterns:
            self.activity_patterns.update(activity_patterns)
        self._lock = threading.Lock()
        self.total_processed = 0
        self.penalized_count = 0
        self.filtered_count = 0

    def is_activity_likely(self, class_name: str, tod: TimeOfDay) -> bool:
        pattern = self.activity_patterns.get(class_name.lower())
        if pattern is None:
            return True  # unknown class — allow
        return tod in _ACTIVE_WINDOWS[pattern]

    def filter_detections(
        self,
        detections: List[Dict[str, Any]],
        current_time: Optional[datetime] = None,
    ) -> List[Dict[str, Any]]:
        if not self.enabled or not detections:
            return detections
        tod = classify_time_of_day(current_time)
        out: List[Dict[str, Any]] = []
        with self._lock:
            self.total_processed += len(detections)
        for det in detections:
            name = (det.get("class_name") or "").lower()
            det["time_of_day"] = tod.value
            if self.is_activity_likely(name, tod):
                out.append(det)
                continue
            if self.hard_filter:
                with self._lock:
                    self.filtered_count += 1
                continue
            if det.get("time_of_day_penalty"):
                # already penalized: the sparse-keyframe gate re-delivers the
                # SAME dicts on non-keyframes; applying the multiplier again
                # would decay confidence exponentially between keyframes
                out.append(det)
                continue
            original = det.get("confidence", 0.0)
            det["confidence"] = original * self.confidence_penalty
            det["time_of_day_penalty"] = True
            det["original_confidence"] = original
            alts = ALTERNATIVE_SUGGESTIONS.get(name, {}).get(tod)
            if alts:
                det["time_of_day_alternatives"] = list(alts)
            with self._lock:
                self.penalized_count += 1
            out.append(det)
        return out

    def update_params(self, config: Dict[str, Any]) -> List[str]:
        """Hot-reload (reference time_of_day_filter.py:273-307)."""
        updated = []
        with self._lock:
            for key in ("enabled", "confidence_penalty", "hard_filter",
                        "use_system_timezone"):
                if key in config and getattr(self, key) != config[key]:
                    setattr(self, key, config[key])
                    updated.append(key)
        return updated

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "total_processed": self.total_processed,
                "penalized_count": self.penalized_count,
                "filtered_count": self.filtered_count,
                "current_time_of_day": classify_time_of_day().value,
            }
