"""Synonym data for METEOR's synonym match stage
(`xfm_tpu/eval/meteor_synonyms.py`, the port's own copy).

meteor-1.5 (the jar the reference shells out to from
refTools/evaluation/meteor/meteor.py) matches two words in its third stage
when they share a WordNet synset. WordNet itself is not redistributable
inside this repo and is unavailable offline, so synonymy resolves in two
tiers:

1. **NLTK WordNet hook** — if `nltk` with the `wordnet` corpus is installed
   in the runtime environment, synsets come from it (full fidelity with the
   jar's synonym stage).
2. **Embedded fallback table** — a compact hand-curated list of synonym
   groups covering the high-frequency caption/VQA vocabulary (COCO-style
   scene descriptions). Most groups mirror a WordNet synset's member set;
   a few marked "caption-loose" accept near-synonyms caption writers use
   interchangeably. This recovers the common caption-domain synonym matches
   (photo/picture, couch/sofa, kid/child, ...) but is NOT all of WordNet;
   corpus scores can still under-estimate meteor-1.5 slightly on
   out-of-domain text.

`synset_ids(word)` returns a frozenset of opaque group ids; two words match
in the synonym stage when their id sets intersect (the jar's criterion).
"""
from __future__ import annotations

import functools
from typing import FrozenSet

# Hand-curated synonym groups (caption/VQA domain). Members of one group
# correspond to one WordNet synset's lemma set (same-sense words only —
# e.g. "street" and "road" are related but not synset-siblings, so they are
# deliberately NOT grouped).
SYNONYM_GROUPS = [
    # people
    ("man", "guy", "gentleman"),
    ("woman", "lady"),
    ("kid", "child", "youngster", "minor"),
    ("baby", "infant"),
    ("boy", "male_child"),
    ("person", "individual", "someone", "somebody"),
    ("people", "folks"),
    ("crowd", "throng"),
    ("friend", "pal", "buddy"),
    ("police", "police_force", "constabulary"),
    ("cop", "police_officer", "policeman", "officer"),
    ("doctor", "physician", "doc"),
    ("athlete", "jock"),
    ("rider", "passenger"),
    ("couple", "pair", "duo", "twosome"),
    ("group", "grouping"),
    # animals
    ("dog", "domestic_dog", "canis_familiaris"),
    ("puppy", "pup"),
    ("cat", "true_cat"),
    ("kitten", "kitty"),
    ("horse", "equus_caballus"),
    ("bird", "fowl"),
    ("cow", "moo-cow"),
    ("cattle", "cows", "kine", "oxen"),
    ("sheep", "ewe"),
    ("rabbit", "coney", "cony"),
    ("bear", "bruin"),
    ("ape", "monkey", "primate"),  # loose: jar groups via synset chains
    # vehicles
    ("car", "auto", "automobile", "machine", "motorcar"),
    ("bike", "bicycle", "cycle", "wheel"),
    ("motorcycle", "motorbike", "bike"),
    ("bus", "autobus", "coach", "motorbus", "omnibus"),
    ("truck", "motortruck", "lorry"),
    ("plane", "airplane", "aeroplane", "aircraft", "jet"),
    ("boat", "watercraft", "vessel"),
    ("ship", "vessel"),
    ("train", "railroad_train"),
    ("taxi", "cab", "taxicab", "hack"),
    ("suv", "sport_utility_vehicle"),
    ("van", "minivan"),
    ("trolley", "streetcar", "tram", "tramcar"),
    ("scooter", "motor_scooter"),
    # objects / furniture
    ("couch", "sofa", "lounge"),
    ("tv", "television", "telly", "television_set", "televisions"),
    ("fridge", "refrigerator", "icebox"),
    ("oven", "stove", "range", "cooker"),
    ("cellphone", "cell_phone", "mobile", "cell", "phone", "telephone"),
    ("laptop", "laptop_computer", "notebook"),
    ("computer", "pc", "machine"),
    ("remote", "remote_control"),
    ("bag", "handbag", "purse", "pocketbook"),
    ("backpack", "knapsack", "rucksack", "packsack", "haversack"),
    ("suitcase", "bag", "traveling_bag", "grip"),
    ("luggage", "baggage"),
    ("umbrella", "brolly"),
    ("eyeglasses", "glasses", "specs", "spectacles"),
    ("sunglasses", "shades", "dark_glasses"),
    ("hat", "chapeau", "lid"),
    ("cap", "hat"),
    ("pants", "trousers", "slacks"),
    ("jeans", "blue_jeans", "denims"),
    ("shirt", "top"),
    ("jacket", "coat"),
    ("shoe", "shoes", "footwear"),
    ("sneaker", "gym_shoe", "tennis_shoe", "trainer"),
    ("bed", "berth", "bunk"),
    ("table", "desk"),  # caption-loose
    ("plate", "dish"),
    ("cup", "mug"),
    ("bottle", "flask"),
    ("jar", "container"),
    ("bowl", "basin"),
    ("knife", "blade"),
    ("blanket", "cover", "covering"),
    ("pillow", "cushion"),
    ("rug", "carpet", "carpeting"),
    ("curtain", "drape", "drapery", "mantle", "pall"),
    ("mirror", "looking_glass"),
    ("picture", "photo", "photograph", "image", "pic", "exposure", "shot"),
    ("toy", "plaything"),
    ("doll", "dolly"),
    ("ball", "globe", "orb"),
    ("gift", "present"),
    ("trash", "garbage", "rubbish", "refuse", "waste"),
    ("trashcan", "garbage_can", "trash_can", "ashbin", "wastebin"),
    ("sign", "signboard"),
    ("signal", "sign"),
    ("clock", "timepiece", "timekeeper"),
    ("watch", "wristwatch", "ticker"),
    ("lamp", "light", "light_source"),
    ("candle", "taper", "wax_light"),
    ("faucet", "tap", "spigot"),
    ("toilet", "commode", "potty", "pot", "lavatory", "john", "privy"),
    ("bathroom", "bath", "washroom", "restroom", "lavatory"),
    ("sink", "washbasin", "basin", "washbowl", "washstand"),
    ("tub", "bathtub", "bath"),
    ("stairs", "steps", "staircase", "stairway"),
    ("elevator", "lift"),
    ("shop", "store"),
    ("house", "home", "dwelling", "abode", "residence", "domicile"),
    ("apartment", "flat"),
    ("building", "edifice"),
    ("skyscraper", "high-rise", "highrise"),
    ("fence", "fencing"),
    ("yard", "grounds", "curtilage"),
    ("garden", "gardens"),
    ("sidewalk", "pavement", "footpath"),
    ("road", "route", "roadway"),
    ("highway", "freeway", "motorway", "expressway", "throughway"),
    ("intersection", "crossroad", "crossing", "carrefour"),
    ("harbor", "harbour", "haven", "seaport", "port"),
    ("pier", "wharf", "dock", "quay"),
    ("beach", "seashore", "shore", "coast", "seacoast"),
    ("ocean", "sea"),
    ("woods", "forest", "wood"),
    ("hill", "mound"),
    ("mountain", "mount"),
    ("stone", "rock"),
    ("grass", "lawn"),  # caption-loose
    ("field", "meadow", "pasture"),
    ("snow", "snowfall"),
    ("rain", "rainfall"),
    ("storm", "tempest"),
    ("fog", "mist", "haze"),
    ("sunset", "sundown"),
    ("sunrise", "dawn", "daybreak", "morning"),
    ("evening", "eve", "eventide"),
    ("night", "nighttime", "dark"),
    ("photo_booth", "photobooth"),
    # food
    ("food", "nutrient", "fare"),
    ("meal", "repast"),
    ("breakfast", "morning_meal"),
    ("dinner", "supper"),
    ("sandwich", "sub", "hoagie", "sandwiches"),
    ("hotdog", "hot_dog", "frankfurter", "frank", "wiener", "weenie"),
    ("hamburger", "burger", "beefburger"),
    ("fries", "french_fries", "chips", "french-fried_potatoes"),
    ("pizza", "pizza_pie"),
    ("soda", "pop", "soda_pop", "tonic"),
    ("candy", "sweets", "confect"),
    ("cookie", "biscuit", "cooky"),
    ("dessert", "sweet", "afters"),
    ("doughnut", "donut", "sinker"),
    ("corn", "maize"),
    ("eggplant", "aubergine"),
    ("zucchini", "courgette"),
    ("scallion", "green_onion", "spring_onion"),
    ("shrimp", "prawn"),
    ("veggie", "vegetable", "veg", "veggies", "vegetables"),
    ("fruit", "fruits"),
    ("drink", "beverage", "potable", "drinkable"),
    ("liquor", "spirits", "booze", "hard_drink"),
    ("beer", "brew", "brewage"),
    # sports / activities
    ("football", "soccer"),  # caption-domain usage
    ("skateboard", "skate_board"),
    ("surfboard", "surf_board"),
    ("snowboard", "snow_board"),
    ("ski", "skis"),
    ("frisbee", "disc", "disk"),
    ("bat", "club"),
    ("racket", "racquet"),
    ("game", "match", "contest"),
    ("competition", "contest"),
    ("trick", "stunt"),
    ("jump", "leap", "bound", "spring"),
    ("run", "running"),
    ("walk", "walking"),
    ("ride", "riding"),
    ("swim", "swimming"),
    ("surf", "surfing"),
    # verbs (base + caption-frequent forms; the stem stage already folds
    # inflections, so groups only need distinct lemmas)
    ("eat", "consume", "ingest"),
    ("drink", "imbibe"),
    ("talk", "speak", "chat", "converse"),
    ("look", "appear", "seem"),
    ("watch", "observe", "view"),
    ("see", "spot", "notice"),
    ("hold", "grasp", "clutch", "grip"),
    ("carry", "transport"),
    ("throw", "toss", "hurl", "fling"),
    ("catch", "grab", "snatch", "snag"),
    ("hit", "strike"),
    ("kick", "boot"),
    ("cut", "slice"),
    ("make", "create", "produce"),
    ("fix", "repair", "mend"),
    ("begin", "start", "commence"),
    ("end", "finish", "stop", "terminate"),
    ("shut", "close"),
    ("leap", "jump"),
    ("sit", "sit_down"),
    ("stand", "stand_up"),
    ("lie", "recline", "repose"),
    ("sleep", "slumber", "kip"),
    ("rest", "relax", "repose"),
    ("smile", "grin"),
    ("laugh", "express_joy", "express_mirth"),
    ("shout", "yell", "scream", "holler", "call"),
    ("happy", "glad", "pleased"),
    ("sad", "unhappy"),
    ("angry", "furious", "mad"),
    ("scared", "frightened", "afraid"),
    ("pretty", "beautiful", "lovely"),
    ("ugly", "unsightly"),
    ("big", "large", "great"),
    ("huge", "enormous", "immense", "vast", "gigantic", "giant"),
    ("small", "little"),
    ("tiny", "miniature", "minuscule"),
    ("tall", "high"),
    ("short", "brief"),
    ("fast", "quick", "speedy", "rapid", "swift"),
    ("slow", "sluggish"),
    ("old", "aged", "elderly"),
    ("new", "fresh", "novel"),
    ("young", "youthful"),
    ("ancient", "antique"),
    ("clean", "spotless"),
    ("dirty", "soiled", "filthy", "grimy", "grubby"),
    ("wet", "moist", "damp"),
    ("dry", "arid"),
    ("cold", "chilly", "frigid"),
    ("hot", "scorching"),
    ("warm", "toasty"),
    ("bright", "brilliant", "vivid"),
    ("dark", "dim", "gloomy"),
    ("shiny", "glossy", "lustrous"),
    ("colorful", "colourful", "vibrant"),
    ("empty", "vacant", "bare"),
    ("full", "filled"),
    ("crowded", "packed", "jammed"),
    ("busy", "bustling"),
    ("quiet", "silent", "still"),
    ("near", "close", "nearby"),
    ("far", "distant", "remote"),
    ("middle", "center", "centre", "midpoint"),
    ("front", "fore"),
    ("rear", "back"),
    ("beside", "alongside", "next_to"),
    ("under", "beneath", "below", "underneath"),
    ("above", "over"),
    ("many", "numerous", "several"),
    ("assorted", "various", "varied", "miscellaneous", "mixed"),
    ("couple", "few"),
    ("whole", "entire"),
    # misc nouns frequent in captions
    ("street", "st"),
    ("avenue", "ave"),
    ("city", "metropolis", "urban_center"),
    ("town", "township"),
    ("area", "region", "zone"),
    ("place", "spot", "location"),
    ("top", "summit", "peak", "crown"),
    ("bottom", "underside", "undersurface"),
    ("side", "face"),
    ("edge", "border", "rim", "brink"),
    ("corner", "nook"),
    ("row", "line"),
    ("bunch", "cluster", "clump"),
    ("stack", "pile", "heap", "mound"),
    ("piece", "slice", "bit"),
    ("half", "one-half"),
    ("lot", "batch", "deal", "plenty"),
    ("kind", "sort", "type", "variety"),
    ("color", "colour"),
    ("shade", "tint", "tone", "hue"),
    ("gray", "grey"),
    ("crimson", "scarlet", "red"),
    ("azure", "cerulean", "sky-blue"),
    ("flower", "bloom", "blossom"),
    ("tree", "trees"),
    ("branch", "limb", "bough"),
    ("leaf", "leafage", "foliage"),
    ("sky", "skies"),
    ("cloud", "clouds"),
    ("water", "h2o"),
    ("river", "stream"),
    ("lake", "pond"),  # caption-loose
    ("fire", "flame", "flames"),
    ("smoke", "fume", "fumes"),
    ("ground", "earth", "land", "soil"),
    ("floor", "flooring"),
    ("wall", "walls"),
    ("ceiling", "roof"),  # caption-loose
    ("door", "doorway", "entrance", "entry", "entryway"),
    ("window", "windowpane"),
    ("airport", "airdrome", "aerodrome", "drome"),
    ("station", "terminal", "depot"),
    ("restaurant", "eatery", "eating_place", "diner"),
    ("cafe", "coffeehouse", "coffee_shop", "coffee_bar"),
    ("kitchen", "kitchens"),
    ("bedroom", "sleeping_room", "chamber", "bedchamber"),
    ("living_room", "livingroom", "sitting_room", "front_room", "parlor",
     "parlour"),
    ("office", "workplace"),
    ("school", "schoolhouse"),
    ("church", "churches"),
    ("market", "marketplace", "mart"),
    ("zoo", "menagerie", "zoological_garden"),
    ("park", "parkland", "commons", "common", "green"),
    ("playground", "play_area"),
    ("stadium", "arena", "bowl", "sports_stadium"),
    ("court", "courts"),
    ("track", "racetrack", "racecourse", "raceway"),
    ("path", "track", "trail"),
    ("bridge", "span"),
    ("tunnel", "underpass"),
    ("runway", "airstrip", "flight_strip", "landing_strip"),
    ("engine", "locomotive", "locomotive_engine", "railway_locomotive"),
    ("carriage", "coach", "wagon"),
    ("cart", "wagon", "waggon"),
    ("tractor", "tractors"),
    ("crane", "cranes"),
    ("kite", "kites"),
    ("balloon", "balloons"),
    ("banner", "streamer"),
    ("flag", "flags"),
    ("pole", "post", "stick"),
    ("wire", "cable", "line"),
    ("rope", "cord"),
    ("chain", "chains"),
    ("wheel", "wheels"),
    ("tire", "tyre"),
    ("helmet", "helmets"),
    ("uniform", "uniforms"),
    ("costume", "outfit", "getup", "rig"),
    ("dress", "frock"),
    ("skirt", "skirts"),
    ("tie", "necktie"),
    ("scarf", "scarves"),
    ("glove", "mitt", "mitten"),
    ("boot", "boots"),
    ("crowd", "mob", "throng", "multitude"),
    ("parade", "procession"),
    ("celebration", "festivity", "festivities"),
    ("party", "bash", "do"),
    ("wedding", "marriage", "wedding_ceremony", "nuptials"),
    ("birthday", "natal_day"),
]


@functools.lru_cache(maxsize=1)
def _fallback_index() -> dict:
    index: dict[str, set] = {}
    for gid, group in enumerate(SYNONYM_GROUPS):
        for w in group:
            index.setdefault(w, set()).add(gid)
    return {w: frozenset(s) for w, s in index.items()}


@functools.lru_cache(maxsize=1)
def _nltk_wordnet():
    """The nltk wordnet corpus if installed AND its data is present."""
    try:  # pragma: no cover - environment-dependent
        from nltk.corpus import wordnet as wn

        wn.synsets("dog")  # raises LookupError when the corpus is missing
        return wn
    except Exception:
        return None


_EMPTY: FrozenSet = frozenset()


@functools.lru_cache(maxsize=65536)
def synset_ids(word: str) -> FrozenSet:
    """Opaque synset-group ids for `word`; two words are synonym-stage
    matches when their id sets intersect."""
    wn = _nltk_wordnet()
    if wn is not None:  # pragma: no cover - needs the wordnet corpus
        return frozenset(s.name() for s in wn.synsets(word))
    return _fallback_index().get(word, _EMPTY)
